"""CTC parity: the port's plain CTC loss (the CPU path and the CUDA
kernels' reference) against the JAX package's XLA scan and its Pallas
kernel in interpret mode, values and gradients w.r.t. log_probs at rtol
1e-5 / atol 1e-5; and against torch's native CTC through the logits.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
compares them with this plain version at the flagship shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llm_bci_tpu.ops import ctc_pallas
from llm_bci_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from llm_bci_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    # per test, as in tests/test_ctc_pallas.py: other modules' fixtures
    # reset the flag
    ctc_pallas.set_interpret_mode(True)
    yield
    ctc_pallas.set_interpret_mode(False)


CASES = ["full_lengths", "partial_lengths", "empty_target", "infeasible_target",
         "repeated_labels", "single_frame"]


def make_case(name):
    """(log_probs, targets, input_lengths, target_lengths) as numpy."""
    rng = np.random.default_rng(CASES.index(name))
    B, T, V, S = 4, 14, 7, 5
    targets = rng.integers(1, V, size=(B, S)).astype(np.int32)
    il = np.full((B,), T, np.int32)
    tl = np.full((B,), S, np.int32)
    if name == "partial_lengths":
        il = np.array([T, T - 1, T - 3, T - 4], np.int32)
        tl = np.array([5, 1, 3, 2], np.int32)
    elif name == "empty_target":
        tl = np.array([0, 2, 0, 5], np.int32)
    elif name == "infeasible_target":
        # 1,1,1,1 needs 7 frames (a blank between repeats); 4 are given
        targets[0] = [1, 1, 1, 1, 3]
        il = np.array([4, T, T, 6], np.int32)
        tl = np.array([4, 5, 2, 5], np.int32)
    elif name == "repeated_labels":
        targets[:] = [[2, 2, 3, 3, 3], [1, 1, 1, 1, 1], [4, 5, 4, 5, 4], [6, 6, 2, 2, 6]]
    elif name == "single_frame":
        T = 1
        il = np.ones((B,), np.int32)
        tl = np.array([0, 1, 1, 2], np.int32)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    log_probs = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    return logits, log_probs, targets, il, tl


def jax_value_and_grad(fn, lp, targets, il, tl):
    def total(x):
        return fn(x, jnp.asarray(targets), jnp.asarray(il), jnp.asarray(tl)).sum()

    vals = fn(jnp.asarray(lp), jnp.asarray(targets), jnp.asarray(il), jnp.asarray(tl))
    return np.asarray(vals), np.asarray(jax.grad(total)(jnp.asarray(lp)))


@pytest.mark.parametrize("case", CASES)
def test_plain_ctc_matches_jax_xla_and_pallas(case):
    _, lp, targets, il, tl = make_case(case)
    x = torch.tensor(lp, requires_grad=True)
    ours = ctc_loss(x, torch.from_numpy(targets), torch.from_numpy(il), torch.from_numpy(tl))
    ours.sum().backward()
    ours_grad = x.grad.numpy()
    assert np.isfinite(ours_grad).all()

    refs = {
        "xla": lambda *a: jax_ctc_loss(*a, impl="xla"),
        "pallas": ctc_pallas.ctc_loss_pallas,
    }
    for name, fn in refs.items():
        vals, grad = jax_value_and_grad(fn, lp, targets, il, tl)
        np.testing.assert_allclose(ours.detach().numpy(), vals, err_msg=name, **TOL)
        np.testing.assert_allclose(ours_grad, grad, err_msg=name, **TOL)
    if case == "infeasible_target":
        assert ours[0].item() == 0.0
        np.testing.assert_array_equal(ours_grad[0], 0.0)
    if case == "empty_target":
        # loss = -sum_t log p(blank) over the valid frames
        np.testing.assert_allclose(ours[0].item(), -lp[0, :, 0].sum(), rtol=1e-5)


@pytest.mark.parametrize("case", ["partial_lengths", "repeated_labels", "infeasible_target"])
def test_plain_ctc_matches_torch_native_through_logits(case):
    # torch's native CTC gradient w.r.t. log_probs assumes log-softmax's
    # backward follows, so the two are compared through the logits.
    logits, _, targets, il, tl = make_case(case)
    grads = []
    for fn in ("ours", "native"):
        x = torch.tensor(logits, requires_grad=True)
        lp = torch.log_softmax(x, -1)
        t, i, l = (torch.from_numpy(a).long() for a in (targets, il, tl))
        if fn == "ours":
            loss = ctc_loss_plain(lp, t, i, l)
        else:
            loss = F.ctc_loss(lp.transpose(0, 1), t, i, l, reduction="none", zero_infinity=True)
        loss.sum().backward()
        grads.append((loss.detach().numpy(), x.grad.numpy()))
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[0][1], grads[1][1], rtol=1e-4, atol=1e-5)


def test_cuda_dispatch_is_lazy_and_cpu_never_builds():
    # The CPU path never touches the kernel module's build; importing the
    # wrapper module builds nothing either.
    import llm_bci_tpu_torch.ops.ctc_cuda as ctc_cuda
    from llm_bci_tpu_torch.ops import _build

    ctc_cuda.reset_counters()
    _, lp, targets, il, tl = make_case("full_lengths")
    ctc_loss(torch.from_numpy(lp), torch.from_numpy(targets), torch.from_numpy(il),
             torch.from_numpy(tl))
    assert (ctc_cuda.FWD_LAUNCHES, ctc_cuda.FUSED_LAUNCHES) == (0, 0) and ctc_cuda._LIB is None
    assert "ctc" not in _build._LOADED
    with pytest.raises(ValueError, match="CUDA"):
        ctc_cuda.ctc_alpha_beta_cuda(
            torch.from_numpy(lp), torch.from_numpy(targets), torch.from_numpy(il),
            torch.from_numpy(tl), 0, True,
        )
