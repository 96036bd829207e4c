"""`ops.tridiag.panel_residual`: a LATRD panel's outputs against the panel
contract's own recurrences, the check `chip_smoke.py` holds the panel
kernels to on the windows a path hands them.

- Every correct panel satisfies it, in float64 to 1e-13 and in float32 to
  1e-5, whatever the window: the port's plain panel with either matvec,
  and the JAX package's Pallas v1 panel (interpret mode, as
  `tests/test_latrd_pallas.py` runs it; its float32 dot_generals leave
  ~2e-6 in float64 outputs, so 1e-5 there too).
- On a nearly deflated window, two correct panels can differ by far more
  than rounding (here the plain panel's two float64 matvecs, by 0.16 of
  the largest output), so a forward comparison is no check there; the
  residual is.
- A fault of 1e-3 in any one output moves the residual above 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.latrd_pallas import latrd_panel as jax_latrd_panel
from laplace_jax_torch.ops.tridiag import lower_half_matvec, panel_plain, panel_residual

torch.set_num_threads(1)

F64_TOL, F32_TOL = 1e-13, 1e-5  # residual of a correct panel
FAULT = 1e-3  # the size of each injected fault
FAULT_SEEN = 1e-4  # the residual a fault of that size must exceed
NB = 64


def _window(kind, K=2):
    """(Aw, off, q_base, n_real) in float64: `full` a symmetric window; `tail`
    the last class of a 576-wide matrix (64 live rows of 256, zero padding);
    `deflated` a rank-40 PSD window at its second panel; `wide` the first
    768-wide class of a 576-wide matrix at its last panel, rank 100."""
    rng = np.random.default_rng({"full": 0, "tail": 1, "deflated": 2, "wide": 3}[kind])
    m, off, q_base, n_real, rank = {"full": (256, 0, 0, 256, None),
                                    "tail": (256, 0, 512, 576, None),
                                    "deflated": (256, 64, 0, 256, 40),
                                    "wide": (768, 192, 0, 576, 100)}[kind]
    live = n_real - q_base
    if rank is None:
        A = rng.standard_normal((K, live, live))
        A = (A + A.transpose(0, 2, 1)) / 2
    else:
        G = rng.standard_normal((K, live, rank))
        A = G @ G.transpose(0, 2, 1) / rank
    Aw = np.zeros((K, m, m))
    Aw[:, :live, :live] = A
    return torch.as_tensor(Aw), off, q_base, n_real


@pytest.mark.parametrize("kind", ["full", "tail", "deflated", "wide"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lower", [False, True])
def test_plain_panel_satisfies_the_recurrences(kind, dtype, lower):
    Aw, off, q_base, n_real = _window(kind)
    Aw = Aw.to(dtype)
    matvec = lower_half_matvec(Aw) if lower else None
    UW, det = panel_plain(Aw, off, q_base, n_real, NB, matvec=matvec)
    res = panel_residual(Aw, off, q_base, n_real, NB, UW, det)
    assert res.shape == (Aw.shape[0],)
    assert float(res.max()) <= (F64_TOL if dtype == torch.float64 else F32_TOL)


def _unpack_pallas(UWT, det, K, m, nb):
    """Pallas (UWT (2nb, K*m), det (nb, 24)) -> port (UW (K, 2nb, m), det (K, 3, nb))."""
    UW = np.array(UWT).reshape(2 * nb, K, m).transpose(1, 0, 2)
    det = np.asarray(det)
    return UW, np.stack([det[:, :K].T, det[:, 8 : 8 + K].T, det[:, 16 : 16 + K].T], 1)


@pytest.mark.parametrize("m,off,n_real", [(128, 0, 122), (256, 16, 250)])
def test_pallas_v1_panel_satisfies_the_recurrences(m, off, n_real):
    K, nb = 2, 16
    rng = np.random.default_rng(4)
    A = rng.standard_normal((K, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    A[:, n_real:, :] = 0
    A[:, :, n_real:] = 0
    UW, det = _unpack_pallas(*jax_latrd_panel(jnp.asarray(A), off, 0, n_real, K=K, m=m,
                                              nb=nb, interpret=True), K, m, nb)
    res = panel_residual(torch.as_tensor(A), off, 0, n_real, nb, torch.as_tensor(UW),
                         torch.as_tensor(det))
    assert float(res.max()) <= F32_TOL


def test_forward_error_is_no_check_on_a_deflated_window():
    """Both float64 matvecs give correct panels (residual <= 1e-13), yet
    their outputs differ by more than 1e-2 of their largest entry."""
    Aw, off, q_base, n_real = _window("deflated")
    full = panel_plain(Aw, off, q_base, n_real, NB)
    lower = panel_plain(Aw, off, q_base, n_real, NB, matvec=lower_half_matvec(Aw))
    for out in (full, lower):
        assert float(panel_residual(Aw, off, q_base, n_real, NB, *out).max()) <= F64_TOL
    fwd = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(lower, full))
    assert fwd > 1e-2


J = 5  # the panel column each fault is put into


def _fault(name, UW, det, c, m, live):
    """Put one fault of size FAULT (relative to the output's scale) into
    column J's outputs; reflector entries are at most 1."""
    w_max = UW[:, NB + J].abs().max()
    if name == "v_entry":
        UW[:, J, c + 3] += FAULT
    elif name == "v_above":
        UW[:, J, c] += FAULT
    elif name == "v_lead":
        UW[:, J, c + 1] += FAULT
    elif name == "v_padding":
        UW[:, J, live if live < m else c - 1] += FAULT
    elif name == "w_entry":
        UW[:, NB + J, c + 3] += FAULT * w_max
    elif name == "w_above":
        UW[:, NB + J, c] += FAULT * w_max
    elif name == "w_stale":
        UW[:, NB + J - 1] = 0
    elif name == "d":
        det[:, 0, J] += FAULT * w_max
    elif name == "e":
        det[:, 1, J] *= 1 + FAULT
    elif name == "tau":
        det[:, 2, J] *= 1 + FAULT


FAULTS = ["v_entry", "v_above", "v_lead", "v_padding", "w_entry", "w_above", "w_stale",
          "d", "e", "tau"]


@pytest.mark.parametrize("kind", ["full", "tail"])
@pytest.mark.parametrize("name", FAULTS)
def test_residual_sees_each_fault(kind, name):
    Aw, off, q_base, n_real = _window(kind)
    Aw = Aw.float()
    UW, det = panel_plain(Aw, off, q_base, n_real, NB)
    assert float(panel_residual(Aw, off, q_base, n_real, NB, UW, det).max()) <= F32_TOL
    _fault(name, UW, det, off + J, Aw.shape[1], n_real - q_base)
    assert float(panel_residual(Aw, off, q_base, n_real, NB, UW, det).min()) > FAULT_SEEN
