"""The kernels' dispatch rule (ops/dispatch.py) as a pure function of (op,
device type, dtype, size), and the wrappers' launch counters.

On a CUDA device a call launches its kernel wherever one takes it:
complex64 and complex128, chi up to the env chain's cap, m up to the
eigensolver's cap of its dtype. Anything else raises before a launch: there
is no non-kernel route on the card. On the CPU every call runs the plain
version. No card here: the CUDA side is checked as the rule and, for the
wrappers' choice of launcher, with the device type answered as on the card
and the kernel library replaced by a recorder."""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import cplx, cuda_lib, dispatch, eigh_kernels
from adaptaqc_tpu_torch.ops import env_kernel

C64, C128 = torch.complex64, torch.complex128
ENV_CAP = dispatch.REACH["env"][C64][1]
EIGH_CAP, EIGH_CAP_64 = (dispatch.REACH["eigh"][C64][1],
                         dispatch.REACH["eigh"][C128][1])
KERNELS = (env_kernel.env_chain, eigh_kernels.tridiag, eigh_kernels.teig,
           eigh_kernels.backtransform)


def test_caps_are_the_kernels_reach():
    assert dispatch.REACH == {
        "env": {C64: (1, 128), C128: (1, 128)},
        "eigh": {C64: (2, 560), C128: (2, 504)}}
    assert env_kernel.NARROW_MAX_CHI == 64
    assert eigh_kernels.NARROW_MAX_M == 128


@pytest.mark.parametrize("size,want", [
    (1, True), (64, True), (65, True), (ENV_CAP - 1, True), (ENV_CAP, True),
    (ENV_CAP + 1, False), (4 * ENV_CAP, False)])
def test_env_route_on_the_card_by_chi(size, want):
    """complex64 and complex128 alike (the double instantiation takes every
    chi the complex64 kernel does); above the cap the call raises."""
    for dtype in (C64, C128):
        if want:
            assert dispatch.use_kernel("env", "cuda", dtype, size)
        else:
            with pytest.raises(ValueError, match="size <= 128"):
                dispatch.use_kernel("env", "cuda", dtype, size)


@pytest.mark.parametrize("size", [1, 2, 128, 129, 256, EIGH_CAP_64,
                                  EIGH_CAP_64 + 1, EIGH_CAP - 1, EIGH_CAP,
                                  EIGH_CAP + 1, 1024])
def test_eigh_route_on_the_card_by_m(size):
    for dtype, hi in ((C64, EIGH_CAP), (C128, EIGH_CAP_64)):
        if 2 <= size <= hi:
            assert dispatch.use_kernel("eigh", "cuda", dtype, size)
        else:
            with pytest.raises(ValueError, match=f"size <= {hi}"):
                dispatch.use_kernel("eigh", "cuda", dtype, size)


@pytest.mark.parametrize("op", ["env", "eigh"])
@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("size", [2, 128, 129, 560, 561, 4096])
def test_cpu_always_takes_the_wrappers(op, dtype, size):
    """On the CPU the wrappers run the plain versions, at any size."""
    assert dispatch.use_kernel(op, "cpu", dtype, size) is False


def test_unknown_op_raises():
    with pytest.raises(KeyError):
        dispatch.use_kernel("svd", "cuda", C64, 4)


@pytest.mark.parametrize("op", ["env", "eigh"])
def test_other_dtypes_and_devices_raise_on_the_card(op):
    """A dtype no kernel takes raises; any device but the CPU is held to
    the card's rule (the wrapper then refuses a non-CUDA tensor:
    test_torch_eigh_kernels.py::test_wrapper_never_falls_back_off_cpu)."""
    for dtype in (torch.float32, torch.complex32, torch.bfloat16):
        with pytest.raises(TypeError):
            dispatch.use_kernel(op, "cuda", dtype, 8)
    assert dispatch.use_kernel(op, "meta", C64, 8)
    with pytest.raises(ValueError):
        dispatch.use_kernel(op, "meta", C64, 4096)


def _reset():
    for fn in KERNELS:
        fn.launches = fn.wide_launches = fn.f64_launches = 0
    for fn in KERNELS[1:]:
        fn.batched_launches = 0


def _counts():
    return {fn.__name__: (fn.launches, fn.wide_launches, fn.f64_launches)
            for fn in KERNELS}


def _gram(m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    t = torch.tensor(a / np.linalg.norm(a), dtype=dtype)
    return t.mH @ t


def test_counters_stay_still_on_the_cpu():
    """CPU calls of either dtype run the plain versions: no launch, no
    count."""
    _reset()
    for dtype in (C64, C128):
        cplx.eigh_top(_gram(8, dtype), 4)
        br = torch.randn(5, 2, 4, 4, dtype=dtype)
        env_kernel.env_chain(br, br, 2)
    assert all(v == (0, 0, 0) for v in _counts().values())


class _Recorder:
    """Stands in for the kernel library: every launcher records its name
    and returns success; the size queries answer as the library does."""

    def __init__(self):
        self.calls = []

    def teig_wide_scratch(self, m):
        return 2 * m * m + ((m + 31) // 32) * m

    def env_chain_f64_partials(self, chi):
        cs = min(8, chi)
        return 2 * cs * cs * (-(-chi // cs)) * chi

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 0
        return launch


@pytest.fixture
def card(monkeypatch):
    """The wrappers as on the card: the rule answered for "cuda", the
    argument checks and the stream query passed, the library recorded."""
    real = dispatch.use_kernel
    monkeypatch.setattr(dispatch, "use_kernel",
                        lambda op, dev, dtype, size: real(op, "cuda", dtype,
                                                          size))
    monkeypatch.setattr(cuda_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", lambda: lib)
    _reset()
    yield lib
    _reset()


def test_counters_move_only_on_launches(card):
    """Each wrapper picks its launcher by dtype and size alone and counts
    one launch per call: complex64 m <= 128 the register designs, above it
    the wide variants (wide_launches), complex128 the double instantiation
    at every m (f64_launches). A call above its cap raises before any
    launch and counts nothing."""
    cplx.eigh_top(_gram(64, C64), 8)
    assert card.calls == ["tridiag_launch", "teig_launch",
                          "backtransform_launch"]
    cplx.eigh_top(_gram(192, C64), 8)
    assert card.calls[3:] == ["tridiag_wide_launch", "teig_wide_launch",
                              "backtransform_wide_launch"]
    cplx.eigh_top(_gram(64, C128), 8)
    assert card.calls[6:] == ["tridiag_f64_launch", "teig_f64_launch",
                              "backtransform_f64_launch"]
    for name in ("tridiag", "teig", "backtransform"):
        assert _counts()[name] == (3, 1, 1)
    with pytest.raises(ValueError):
        cplx.eigh_top(_gram(EIGH_CAP_64 + 8, C128), 8)
    assert len(card.calls) == 9
    assert _counts()["tridiag"] == (3, 1, 1)

    for dtype, chi, launcher in ((C64, 8, "env_chain_launch"),
                                 (C64, 96, "env_chain_launch"),
                                 (C128, 96, "env_chain_f64_launch")):
        br = torch.zeros(6, 2, chi, chi, dtype=dtype)
        env_kernel.env_chain(br, br, 3)
        assert card.calls[-1] == launcher
    assert _counts()["env_chain"] == (3, 1, 1)
    with pytest.raises(ValueError):
        br = torch.zeros(2, 2, ENV_CAP + 8, ENV_CAP + 8, dtype=C64)
        env_kernel.env_chain(br, br, 0)
    assert len(card.calls) == 12 and _counts()["env_chain"] == (3, 1, 1)
