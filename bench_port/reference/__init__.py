"""Plain PyTorch / NumPy reference of what the benchmark's cells run. Imports
nothing of the program under test.

``common`` holds what every model shares (precision, weights, schedule,
AdamW, CER); each model has a module of its own, found by its
configuration's ``model_class`` in lower case (``NDT1`` ->
``reference/ndt1.py``). A model module gives
``param_spec(model, n_channels, n_outputs)``, ``train_step(params, batch,
model, method, gen, prec)``, ``draw_only(model, method, shape, gen,
device)`` and ``step_flops_per_sample(model, bins, n_channels, n_outputs)``.
"""
import importlib


def model_module(config: dict):
    """The reference module of a configuration file's model."""
    return importlib.import_module(f"reference.{config['trainer']['model']['model_class'].lower()}")
