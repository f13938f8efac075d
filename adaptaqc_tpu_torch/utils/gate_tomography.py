"""n-parameter cost-function tomography.

The port's copy of the JAX package's `utils/gate_tomography.py` (NumPy
only), after the reference's gate_tomography.py: evaluate the
cost on the 3^n grid theta in {-pi/2, 0, +pi/2}^n (base-3 digit order
0 -> -pi/2, 1 -> 0, 2 -> +pi/2), transform per-axis to the
{cos^2(t/2), cos(t/2)sin(t/2), sin^2(t/2)} basis, and reconstruct the cost
analytically at arbitrary angles. Vectorised over the grid instead of the
reference's per-index base-3 string loops.
"""

from __future__ import annotations

import numpy as np

_PROBES = np.array([-np.pi / 2, 0.0, np.pi / 2])


def angle_sets_to_evaluate(num_params: int) -> np.ndarray:
    """(3^n, n) probe grid (gate_tomography.py:15-37): row i's digit j (most
    significant first) indexes (-pi/2, 0, +pi/2)."""
    grids = np.meshgrid(*([_PROBES] * num_params), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


def measurements_to_zero_delta_pi_bases(measurements) -> np.ndarray:
    """Per-axis transform (gate_tomography.py:40-76):
    (f(-pi/2), f(0), f(+pi/2)) -> (f(0), f(pi/2)-f(-pi/2), f(pi))."""
    m = np.array(measurements, dtype=float)
    num_params = int(round(np.log(len(m)) / np.log(3)))
    m = m.reshape([3] * num_params)
    t = np.array([[0.0, 1.0, 0.0],    # f(0)
                  [-1.0, 0.0, 1.0],   # f(pi/2) - f(-pi/2)
                  [1.0, -1.0, 1.0]])  # f(pi) = f(pi/2)+f(-pi/2)-f(0)
    for axis in range(num_params):
        m = np.moveaxis(np.tensordot(t, m, axes=([1], [axis])), 0, axis)
    return m.reshape(-1)


def reconstructed_cost(angles, measurements) -> float:
    """Evaluate the reconstructed cost (gate_tomography.py:79-104): digit
    d of index i weights cos^2 (d=0), cos*sin (d=1), sin^2 (d=2) of theta/2."""
    angles = np.atleast_1d(np.asarray(angles, dtype=float))
    num_params = len(angles)
    m = np.asarray(measurements, dtype=float).reshape([3] * num_params)
    for axis in range(num_params):
        half = angles[axis] / 2
        basis = np.array([np.cos(half) ** 2,
                          np.cos(half) * np.sin(half),
                          np.sin(half) ** 2])
        m = np.tensordot(basis, m, axes=([0], [0]))
    return float(m)
