"""Closed-form sinusoidal math shared by Rotosolve (host numpy + tensors).

The cost as a function of any single rotation angle is a*sin(x+b)+c; three
evaluations at {0, +pi/2, -pi/2} determine the minimum in closed form
(adapt-aqc's adaptaqc/utils/utilityfunctions.py:34-95).
"""

import numpy as np
import torch


def minimum_of_sinusoidal(value_0, value_pi_by_2, value_minus_pi_by_2):
    """Host (numpy) version. Returns (x_min in [-pi, pi], f(x_min))."""
    theta_min = -(np.pi / 2) - np.arctan2(
        2 * value_0 - value_pi_by_2 - value_minus_pi_by_2,
        value_pi_by_2 - value_minus_pi_by_2,
    )
    theta_min = normalized_angle(theta_min)
    intercept_c = 0.5 * (value_pi_by_2 + value_minus_pi_by_2)
    value_pi = (value_pi_by_2 + value_minus_pi_by_2) - value_0
    amplitude_a = 0.5 * np.sqrt(
        (value_0 - value_pi) ** 2 + (value_pi_by_2 - value_minus_pi_by_2) ** 2
    )
    return theta_min, intercept_c - amplitude_a


def amplitude_of_sinusoidal(value_0, value_pi_by_2, value_minus_pi_by_2):
    value_pi = (value_pi_by_2 + value_minus_pi_by_2) - value_0
    return 0.5 * np.sqrt(
        (value_0 - value_pi) ** 2 + (value_pi_by_2 - value_minus_pi_by_2) ** 2
    )


def derivative_of_sinusoidal(theta, value_0, value_pi_by_2, value_minus_pi_by_2):
    value_pi = (value_pi_by_2 + value_minus_pi_by_2) - value_0
    amplitude_a = 0.5 * np.sqrt(
        (value_0 - value_pi) ** 2 + (value_pi_by_2 - value_minus_pi_by_2) ** 2
    )
    phase_b = np.arctan2(value_0 - value_pi, value_pi_by_2 - value_minus_pi_by_2)
    return amplitude_a * np.cos(theta + phase_b)


def normalized_angle(angle):
    """Normalize to [-pi, pi]."""
    return (angle + np.pi) % (2 * np.pi) - np.pi


def normalized_angles(angles):
    from collections.abc import Iterable
    if isinstance(angles, Iterable):
        return [float(normalized_angle(a)) for a in angles]
    return float(normalized_angle(angles))


def minimum_of_sinusoidal_dev(v0, vp, vm):
    """Tensor version (stays on the tensors' device); vectorises over
    leading axes."""
    theta = -(np.pi / 2) - torch.atan2(2 * v0 - vp - vm, vp - vm)
    theta = torch.where(theta < -np.pi, theta + 2 * np.pi, theta)
    c = 0.5 * (vp + vm)
    vpi = (vp + vm) - v0
    a = 0.5 * torch.sqrt((v0 - vpi) ** 2 + (vp - vm) ** 2)
    return theta, c - a


def has_stopped_improving(cost_history, rel_tol=1e-2):
    """Linear-fit relative slope test (utilityfunctions.py:272-278)."""
    try:
        fit = np.polyfit(list(range(len(cost_history))), cost_history, 1)
        grad = fit[0] / np.absolute(np.mean(cost_history))
        return grad > -1 * rel_tol
    except np.linalg.LinAlgError:
        return False
