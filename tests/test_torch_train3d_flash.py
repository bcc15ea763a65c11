"""Two whole train steps of the port against JAX where both take the flash
backward: FLASH_BWD_MIN_N is patched to 0 in both packages for the test
(the JAX step is traced afresh after the patch), so the 72-token volume
of the tiny Segtran3d runs the Pallas flash backward (interpret mode) in
JAX and the plain version of the port's dK/dV and dQ kernels here. See
tests/_torch_train3d.py for what is compared and the tolerances."""
import pytest

from _torch_train3d import check_two_train_steps, make_jax_side
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side()


def test_two_train_steps_on_the_flash_backward_match_jax(jax_side,
                                                         monkeypatch):
    check_two_train_steps("flash_bwd", jax_side, monkeypatch)
