"""The streamed env chain's plan (K1 past chi = 128, csrc/env_chain_stream.cu;
its Python mirror env_kernel.stream_config / stream_slices / stream_work):
every output and every depth index of every launch covered exactly once,
the card filled where the depth is split, and the kernel's order of
operations giving the same bits over different CTA tiles. No card here:
the plan is a pure function, and the order is emulated in torch
(test_torch_reach.product_order); chip_smoke.py holds the mirror equal to
the library's plan and the kernel to its plain version on the card."""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import env_kernel

from test_torch_reach import _sites, _views, product_order

torch.set_num_threads(1)

# chip_smoke.REACH_CHI and REACH_CHI_F64, and 2048 and 4096, the caps before
REACH_CHI = (129, 192, 256, 512, 768, 1024, 2048, 4096, 8192)
REACH_CHI_F64 = (192, 256, 512, 1024, 2048, 4096, 8192)
WAVE = 132  # the H100 SXM's SMs


def _cover(chi, step):
    """How many times each index of [0, chi) lies in the tiles of `step`
    starting at 0, step, 2 step, ... (clipped at chi)."""
    count = np.zeros(chi, int)
    for i0 in range(0, chi, step):
        count[i0:min(i0 + step, chi)] += 1
    return count


@pytest.mark.parametrize("f64", [False, True], ids=["c64", "c128"])
@pytest.mark.parametrize("chi", sorted(set(REACH_CHI) | set(REACH_CHI_F64)))
def test_plan_covers_every_output_and_depth_once(chi, f64):
    """For each launch the host loop makes (STREAM_LAUNCHES: step 1 of two
    chains or one, whose first is also the combine's; step 2 of two or
    one): the CTA grid's row and column tiles cover each of the chi x chi
    outputs once; the slices, [s T / S, (s + 1) T / S) of the T depth
    tiles, are nonempty and cover each depth index (p, a) of the np chi
    once; where the plan splits (S > 1) the launch has at least one wave
    of 132 CTAs, and S stays within STREAM_MAX_SLICES. The scratch holds
    the environments and every split launch's partial sums."""
    bm, bn, bk, _ = env_kernel.STREAM_CONFIGS[
        env_kernel.stream_config(chi, f64)]
    assert (_cover(chi, bm) == 1).all() and (_cover(chi, bn) == 1).all()
    part = 0
    for products, np_ in env_kernel.STREAM_LAUNCHES:
        s = env_kernel.stream_slices(chi, f64, products, np_)
        ktp = -(-chi // bk)
        total = np_ * ktp
        assert 1 <= s <= min(total, env_kernel.STREAM_MAX_SLICES)
        depth = np.zeros((np_, chi), int)
        for sl in range(s):
            t0, t1 = sl * total // s, (sl + 1) * total // s
            assert t1 > t0
            for t in range(t0, t1):
                p, a0 = divmod(t, ktp)
                depth[p, a0 * bk:min(a0 * bk + bk, chi)] += 1
        assert (depth == 1).all()
        ctas = -(-chi // bm) * -(-chi // bn) * products
        if s > 1:
            assert ctas * s >= WAVE
            part = max(part, s * products)
    assert env_kernel.stream_work(chi, f64) == (6 + part) * chi * chi


def test_plan_fills_the_card_where_a_launch_is_short():
    """Where a launch has fewer CTAs than one wave it is split: at chi =
    256 step 2 of one chain (16 CTAs of 64 x 64) and of both; at chi =
    1024 (128 x 128 tiles, 64 a product) step 2 of one chain, not step 1
    of both (256 CTAs) nor step 2 of both (128: a split into two waves
    gains nothing); complex128 at chi = 1024 splits nothing."""
    assert env_kernel.stream_slices(256, False, 1, 2) > 1
    assert env_kernel.stream_slices(256, False, 2, 2) > 1
    assert env_kernel.stream_slices(1024, False, 1, 2) > 1
    assert env_kernel.stream_slices(1024, False, 4, 1) == 1
    assert env_kernel.stream_slices(1024, False, 2, 2) == 1
    assert all(env_kernel.stream_slices(1024, True, p, n) == 1
               for p, n in env_kernel.STREAM_LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_product_bits_do_not_depend_on_the_cta_tile(dtype):
    """Step 2 of the forward chain at chi = 160 (L = A_p^H over the depth
    2 chi, both of its layouts' strides), summed in the kernel's order over
    3 depth slices: computed whole, and tile by tile over 64 x 64 and 128 x
    32 CTA tiles (ragged edges), the same bits; over 1 and 5 slices the
    same to rounding (1e-12 relative in complex128, 1e-5 in complex64)."""
    chi = 160
    br, bl = (torch.tensor(x, dtype=dtype) for x in _sites(2, chi, seed=5))
    m = torch.tensor(_sites(1, chi, seed=6)[0][0], dtype=dtype)
    cc = chi * chi
    ls, rs = _views(br.reshape(-1), m.reshape(-1), True, 1, chi, cc, chi, 1,
                    cc, 2, chi)
    bk = 8 if dtype == torch.complex128 else 16
    whole = product_order(ls, rs, 3, bk)
    for bm, bn in ((64, 64), (128, 32)):
        tiled = torch.zeros_like(whole)
        for i0 in range(0, chi, bm):
            for j0 in range(0, chi, bn):
                rows, cols = slice(i0, i0 + bm), slice(j0, j0 + bn)
                tiled[rows, cols] = product_order(ls, rs, 3, bk, rows, cols)
        assert torch.equal(tiled, whole), (bm, bn)
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    ref = sum(l @ r for l, r in zip(ls, rs))
    for slices in (1, 5):
        other = product_order(ls, rs, slices, bk)
        assert float((other - whole).abs().max() / ref.abs().max()) < tol
    assert float((whole - ref).abs().max() / ref.abs().max()) < tol
