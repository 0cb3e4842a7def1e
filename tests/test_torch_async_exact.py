"""`rollout_chunked(reset_mode="async", exact=True)` against the JAX
package, tolerance zero: test_torch_async.py's setting and check with
dead steps that draw nothing (and their count compared)."""
from test_torch_async import check_against_jax


def test_async_exact_equals_jax():
    check_against_jax(exact=True)
