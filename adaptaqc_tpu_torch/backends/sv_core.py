"""Gate matrices of tape entries, for the engines.

Counterpart of `build_u4` in the JAX package's `backends/sv_core.py`; the
statevector engine itself is not ported yet (ROADMAP). Matrices use the
two-qubit basis index r = 2*b(q1) + b(q0); one-qubit gates act on q0 and
embed as kron(I2, U).
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuits import gates as G
from ..circuits.tape import U4_TABLE

_TABLE_CACHE = {}
_PAULI_CACHE = {}


def u4_table(dtype: torch.dtype, device) -> torch.Tensor:
    """U4_TABLE (N_KINDS + 1, 4, 4) on the device, built once per dtype."""
    key = (dtype, str(device))
    t = _TABLE_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(U4_TABLE, dtype=dtype, device=device)
        _TABLE_CACHE[key] = t
    return t


def paulis(dtype: torch.dtype, device) -> torch.Tensor:
    """(X, Y, Z) as a (3, 2, 2) tensor on the device."""
    key = (dtype, str(device))
    t = _PAULI_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(G.PAULIS_NP, dtype=dtype, device=device)
        _PAULI_CACHE[key] = t
    return t


def rotation_u2(axis: torch.Tensor, angle: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """cos(a/2) I - i sin(a/2) P_axis for (batched) axis in {0, 1, 2} =
    (X, Y, Z) and real angle; stays on the device (no host sync)."""
    dev = angle.device
    p = paulis(dtype, dev)[axis]  # (..., 2, 2)
    half = angle.to(torch.empty((), dtype=dtype).real.dtype) * 0.5
    c = torch.cos(half)[..., None, None]
    s = torch.sin(half)[..., None, None]
    eye = torch.eye(2, dtype=dtype, device=dev)
    return c * eye - 1j * s * p


def build_u4(kinds: torch.Tensor, angles: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """(G, 4, 4) gate matrices for tape entries (kinds (G,) int tensor,
    angles (G,) real tensor, both on the target device)."""
    dev = kinds.device
    fixed = u4_table(dtype, dev)[kinds]
    is_rot = (kinds >= G.RX) & (kinds <= G.RZ)
    axis = torch.clamp(kinds - G.RX, 0, 2)
    u2 = rotation_u2(axis, angles, dtype)
    rot = torch.zeros_like(fixed)
    rot[..., :2, :2] = u2
    rot[..., 2:, 2:] = u2
    return torch.where(is_rot[..., None, None], rot, fixed)


def is_two_qubit(kind: int) -> bool:
    return kind in (G.CX, G.CZ, G.SWAP) or kind >= G.N_KINDS


def two_qubit_mask(kinds: np.ndarray) -> np.ndarray:
    kinds = np.asarray(kinds)
    return ((kinds == G.CX) | (kinds == G.CZ) | (kinds == G.SWAP)
            | (kinds >= G.N_KINDS))
