/* Mirrors llm_bci_tpu/native/editdistance.c: the port keeps its own copy. */
/* Token-sequence Levenshtein distance over int32 id arrays.
 *
 * Native replacement for the `editdistance` C++ extension the reference
 * leans on (reference utils/eval_bci.py:6,14). The Python side interns
 * tokens to int32 ids and calls this over two id arrays; two DP rows,
 * O(min(n,m)) memory.
 *
 * Built on first use by llm_bci_tpu/native/__init__.py with
 *   cc -O3 -shared -fPIC editdistance.c -o _editdistance.so
 */
#include <stdint.h>
#include <stdlib.h>

int64_t edit_distance_i32(const int32_t *a, int64_t n,
                          const int32_t *b, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;

    /* Iterate the longer sequence outside, keep rows over the shorter. */
    const int32_t *s = a, *t = b;
    int64_t ns = n, nt = m;
    if (ns < nt) {
        s = b; t = a;
        ns = m; nt = n;
    }

    int64_t *prev = (int64_t *)malloc((size_t)(nt + 1) * sizeof(int64_t));
    int64_t *cur = (int64_t *)malloc((size_t)(nt + 1) * sizeof(int64_t));
    if (!prev || !cur) {
        free(prev); free(cur);
        return -1;
    }
    for (int64_t j = 0; j <= nt; ++j) prev[j] = j;

    for (int64_t i = 1; i <= ns; ++i) {
        cur[0] = i;
        const int32_t si = s[i - 1];
        for (int64_t j = 1; j <= nt; ++j) {
            int64_t sub = prev[j - 1] + (si != t[j - 1]);
            int64_t del = prev[j] + 1;
            int64_t ins = cur[j - 1] + 1;
            int64_t best = sub < del ? sub : del;
            cur[j] = best < ins ? best : ins;
        }
        int64_t *tmp = prev; prev = cur; cur = tmp;
    }
    int64_t out = prev[nt];
    free(prev); free(cur);
    return out;
}
