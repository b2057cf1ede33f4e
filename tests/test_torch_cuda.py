"""Tests of the port's CUDA kernels; they need a card (marker ``cuda``) and
skip themselves elsewhere. Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

* the device rule: a CUDA tensor launches the kernel (its launch counter
  rises) and never takes the plain version;
* each kernel against its plain version on the card over ragged shapes,
  f32 and bf16 (tolerance: f32 1e-5 — the kernel and the plain version
  sum in other orders; bf16 3e-2 — one rounding step of O(1) outputs).
  ``fed_mix_matching`` is held bit for bit: each of its operations is one
  rounding in the plain version's order. Its large-D device-memory path
  (one launch per stage) is covered at D = 2048 and 4096;
* the wrapper guards hold on CUDA tensors too; a bad cluster id is flagged
  on the card and raised by ``check_cluster_ids``.
"""
import pytest
import torch

from repro_torch.compression import Int8Codec
from repro_torch.kernels import backend, ref
from repro_torch.kernels.fed_aggregate import fed_aggregate
from repro_torch.kernels.fed_mix import fed_mix
from repro_torch.kernels.fed_mix_q import fed_mix_q
from repro_torch.kernels.fed_mix_sparse import (
    check_cluster_ids, fed_mix_matching, fed_mix_segment,
)
from repro_torch.protocols.async_gossip import matching_perm_stack
from repro_torch.protocols.gossip import _phase_perm_stack

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    backend.use_full_f32()
    return torch.Generator(device="cuda").manual_seed(0)


def _segment_args(gen, d, p, L, dtype):
    kw = dict(device="cuda", generator=gen)
    ids = torch.randint(0, L, (d,), dtype=torch.int32, **kw)
    w_new = torch.rand(d, **kw) / d
    w_old = torch.rand(d, **kw) / d
    return (ids, w_new, w_old, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _dense_args(gen, d, p, dtype):
    kw = dict(device="cuda", generator=gen)
    mn, mo = torch.rand((d, d), **kw), torch.rand((d, d), **kw)
    tot = (mn + mo).sum(dim=1, keepdim=True)
    return (mn / tot, mo / tot, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _matching_args(gen, d, p, stages, dtype):
    kw = dict(device="cuda", generator=gen)
    if stages == 2:
        perms = torch.from_numpy(_phase_perm_stack(d))
    else:
        stack = torch.from_numpy(matching_perm_stack(d))
        perms = stack[torch.randint(0, stack.shape[0], (stages,))]
    survive = (torch.rand(d, **kw) > 0.3).float()
    return (perms.cuda().contiguous(), survive,
            torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _quant_args(gen, d, p, chunk, x_dtype):
    mn, mo, xn, xo = _dense_args(gen, d, p, torch.float32)
    enc = Int8Codec(chunk=chunk).encode(
        xn, u=torch.rand((d, Int8Codec(chunk=chunk).padded(p)),
                         device="cuda", generator=gen))
    return mn, mo, enc.values, enc.scales, xo.to(x_dtype)


def test_cuda_tensor_launches_kernel_not_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("fed_mix_segment_ref", "fed_mix_ref",
                 "fed_mix_matching_ref", "fed_mix_q_ref",
                 "fed_aggregate_ref"):
        monkeypatch.setattr(ref, name, refuse)
    n0 = fed_mix_segment.launches
    out = fed_mix_segment(*_segment_args(cuda, 6, 9, 3, torch.float32),
                          num_segments=3)
    torch.cuda.synchronize()
    assert fed_mix_segment.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix.launches
    out = fed_mix(*_dense_args(cuda, 6, 9, torch.float32))
    torch.cuda.synchronize()
    assert fed_mix.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix_matching.launches
    out = fed_mix_matching(*_matching_args(cuda, 6, 9, 2, torch.float32))
    torch.cuda.synchronize()
    assert fed_mix_matching.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix_q.launches
    out = fed_mix_q(*_quant_args(cuda, 6, 9, 64, torch.float32), chunk=64)
    torch.cuda.synchronize()
    assert fed_mix_q.launches == n0 + 1 and out.is_cuda
    n0 = fed_aggregate.launches
    out = fed_aggregate(torch.randn((6, 9), device="cuda"),
                        torch.rand(6, device="cuda"))
    torch.cuda.synchronize()
    assert fed_aggregate.launches == n0 + 1 and out.is_cuda


@pytest.mark.parametrize("d,p,L", [(1, 1, 1), (7, 130, 3), (37, 1000, 37),
                                   (37, 1001, 5), (100, 4099, 10),
                                   (1000, 130, 1000), (2048, 257, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_segment_matches_plain_on_card(cuda, d, p, L, dtype):
    args = _segment_args(cuda, d, p, L, dtype)
    got = fed_mix_segment(*args, num_segments=L)
    want = ref.fed_mix_segment_ref(*args, num_segments=L)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("d,p", [(1, 1), (7, 130), (37, 1000), (100, 4099),
                                 (300, 513)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_matches_plain_on_card(cuda, d, p, dtype):
    args = _dense_args(cuda, d, p, dtype)
    got = fed_mix(*args)
    want = ref.fed_mix_ref(*args)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("d,p,stages", [(1, 1, 1), (2, 5, 2), (9, 1001, 2),
                                        (17, 513, 2), (100, 4099, 1),
                                        (100, 4099, 2), (37, 130, 3),
                                        (5, 64, 0),
                                        (2048, 999, 2), (4096, 257, 1),
                                        (1000, 130, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_matching_bitwise_on_card(cuda, d, p, stages, dtype):
    """Bit for bit with the plain version, on the shared-memory path and on
    the device-memory path (D = 1000 and up: one launch per stage)."""
    if stages == 3:
        perms = torch.from_numpy(matching_perm_stack(d)[[0, 3, 1]]).cuda()
        _, survive, xn, xo = _matching_args(cuda, d, p, 1, dtype)
        args = (perms.contiguous(), survive, xn, xo)
    elif stages == 0:
        _, survive, xn, xo = _matching_args(cuda, d, p, 1, dtype)
        args = (torch.zeros((0, d), dtype=torch.int32, device="cuda"),
                survive, xn, xo)
    else:
        args = _matching_args(cuda, d, p, stages, dtype)
    got = fed_mix_matching(*args)
    want = ref.fed_mix_matching_ref(*args)
    assert got.dtype == dtype and got.shape == (d, p)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d,p,chunk", [(6, 700, 256), (16, 4096, 256),
                                       (17, 513, 128), (1, 129, 64),
                                       (40, 300, 128), (100, 4099, 256),
                                       (7, 130, 6)])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_fed_mix_q_matches_plain_on_card(cuda, d, p, chunk, x_dtype,
                                         out_dtype):
    args = _quant_args(cuda, d, p, chunk, x_dtype)
    got = fed_mix_q(*args, chunk=chunk, out_dtype=out_dtype)
    want = ref.fed_mix_q_ref(*args, chunk=chunk, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[out_dtype], atol=TOL[out_dtype])


def test_fed_mix_q_unaligned_record_on_card(cuda):
    """An int8 record whose rows are not 4-byte aligned takes the
    one-byte-a-load path and is still right."""
    d, p, chunk = 5, 72, 6
    mn, mo, q, sc, xo = _quant_args(cuda, d, p, chunk, torch.float32)
    base = torch.zeros(d * q.shape[1] + 1, dtype=torch.int8, device="cuda")
    qv = base[1:].view(d, q.shape[1])
    qv.copy_(q)
    got = fed_mix_q(mn, mo, qv, sc, xo, chunk=chunk)
    want = ref.fed_mix_q_ref(mn, mo, q, sc, xo, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d", [(1, 1), (3, 1000), (8, 4096), (1, 17),
                                 (16, 513), (100, 4099), (13, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_aggregate_matches_plain_on_card(cuda, n, d, dtype):
    x = torch.randn((n, d), device="cuda", generator=cuda).to(dtype)
    w = torch.rand(n, device="cuda", generator=cuda)
    w = w / w.sum()
    got = fed_aggregate(x, w)
    want = ref.fed_aggregate_ref(x, w)
    assert got.dtype == dtype and got.shape == (d,)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_fed_mix_segment_unaligned_view_on_card(cuda):
    """A contiguous view 4 bytes off an 8-byte boundary takes the
    one-column-a-thread path and is still right."""
    d, p = 9, 64
    base = torch.randn(2, d * p + 1, device="cuda", generator=cuda)
    xn, xo = base[0, 1:].view(d, p), base[1, 1:].view(d, p)
    ids, wn, wo, _, _ = _segment_args(cuda, d, p, 3, torch.float32)
    got = fed_mix_segment(ids, wn, wo, xn, xo, num_segments=3)
    want = ref.fed_mix_segment_ref(ids, wn, wo, xn, xo, num_segments=3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,p,L", [(6, 12, 3), (6, 13, 3), (1000, 130, 1000)])
def test_bad_cluster_ids_flagged_on_card(cuda, d, p, L):
    """A bad id is not read back at the launch: its row comes out NaN, the
    other rows are right, and ``check_cluster_ids`` raises once."""
    ids, wn, wo, xn, xo = _segment_args(cuda, d, p, L, torch.float32)
    check_cluster_ids()
    bad = ids.clone()
    bad[0], bad[-1] = L, -1
    got = fed_mix_segment(bad, wn, wo, xn, xo, num_segments=L)
    keep = torch.ones(d, dtype=torch.bool, device="cuda")
    keep[0] = keep[-1] = False
    want = ref.fed_mix_segment_ref(ids, wn * keep, wo * keep, xn, xo,
                                   num_segments=L)
    assert torch.isnan(got[0]).all() and torch.isnan(got[-1]).all()
    torch.testing.assert_close(got[1:-1], want[1:-1], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="outside \\[0, num_segments\\)"):
        check_cluster_ids(torch.device("cuda"))
    check_cluster_ids()      # the flag was cleared


def test_guards_on_card(cuda):
    ids, wn, wo, xn, xo = _segment_args(cuda, 6, 12, 3, torch.float32)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix_segment(ids, wn, wo, xn[:, ::2], xo[:, ::2], num_segments=3)
    with pytest.raises(ValueError, match="several devices"):
        fed_mix_segment(ids, wn, wo, xn, xo.cpu(), num_segments=3)
    perms, survive, xn, xo = _matching_args(cuda, 6, 12, 2, torch.float32)
    with pytest.raises(ValueError, match="several devices"):
        fed_mix_matching(perms.cpu(), survive, xn, xo)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        fed_mix_q(*_quant_args(cuda, 6, 12, 64, torch.float32), chunk=48)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_aggregate(xn[:, ::2], survive)


def test_fed_mix_matching_bad_partner_is_nan_on_card(cuda):
    """Partner indices are not read back on the card: a row whose partner
    lies outside [0, D) comes out NaN and the other rows are right."""
    perms, survive, xn, xo = _matching_args(cuda, 8, 40, 1, torch.float32)
    bad = perms.clone()
    bad[0, 3] = 8
    got = fed_mix_matching(bad, survive, xn, xo)
    want = ref.fed_mix_matching_ref(perms, survive, xn, xo)
    assert torch.isnan(got[3]).all()
    keep = [i for i in range(8) if i != 3]
    assert torch.equal(got[keep], want[keep])
