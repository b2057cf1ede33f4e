"""The structured-sparse mixing kernels, on packed [D, P] buffers with no
[D, D] operator:

* ``fed_mix_segment`` — the cluster-segment ``SegmentSpec`` (FedAvg,
  FedP2P; the global server step is its L=1 case),

      out_i = sum_{j: c(j)=c(i)} (w_new_j x_new_j + w_old_j x_old_j)

  in O(D·P) work. The kernel is ``csrc/fed_mix_segment.cu`` (one fused
  pass, replacing the two Pallas calls of
  ``repro.kernels.fed_mix_sparse.fed_mix_segment``); CPU tensors take
  ``ref.fed_mix_segment_ref``.
* ``fed_mix_matching`` — the pairwise-matching ``MatchingSpec`` (gossip,
  gossip_async): straggler substitution, then S stages of averaging every
  row with its partner, in O(S·D·P) work. The kernel is
  ``csrc/fed_mix_matching.cu`` (replacing
  ``repro.kernels.fed_mix_sparse.fed_mix_matching``; at S <= 3 each output
  row is the rounding tree over the 2^S rows its stages reach, bit for bit
  the stage loop); CPU tensors take ``ref.fed_mix_matching_ref``.

Bad cluster ids: on the TPU an id outside [0, L) silently drops out of the
one-hot. Here it raises ``ValueError``. On CPU tensors the wrapper raises
at once. On CUDA tensors it does not read the ids back (that would stop
the host at every launch): the kernel gives each such row a NaN output and
sets a flag on the card, and ``check_cluster_ids`` raises at the caller's
next synchronisation — ``Simulator.run`` calls it after its one read-back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)
#: per CUDA device: one int32 the kernel sets to 1 on a bad cluster id
_bad_ids: Dict[torch.device, torch.Tensor] = {}


def _bad_ids_flag(device: torch.device) -> torch.Tensor:
    if device not in _bad_ids:
        _bad_ids[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _bad_ids[device]


def check_cluster_ids(device: Optional[torch.device] = None) -> None:
    """Raise ``ValueError`` when a launch on ``device`` (every CUDA device
    when None) since the last check was given a cluster id outside
    [0, num_segments), and clear the flag. Reads one int per device back
    to the host; a no-op for the CPU, whose wrapper raises at once."""
    want = None if device is None else torch.device(device)
    for dev in list(_bad_ids):
        if want is not None and (dev.type != want.type or want.index
                                 not in (None, dev.index)):
            continue
        flag = _bad_ids[dev]
        if int(flag.item()):
            flag.zero_()
            raise ValueError(
                f"fed_mix_segment: a launch on {dev} was given cluster_ids "
                f"outside [0, num_segments); its rows came out NaN")


def _check(cluster_ids, w_new, w_old, x_new, x_old, num_segments) -> str:
    name = "fed_mix_segment"
    if x_new.dim() != 2:
        raise ValueError(f"{name}: x_new must be [D, P], got shape "
                         f"{tuple(x_new.shape)}")
    if x_new.shape != x_old.shape:
        raise ValueError(f"{name}: x_new {tuple(x_new.shape)} and x_old "
                         f"{tuple(x_old.shape)} differ in shape")
    if x_new.dtype != x_old.dtype:
        raise ValueError(f"{name}: x_new ({x_new.dtype}) and x_old "
                         f"({x_old.dtype}) differ in dtype")
    if x_new.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype must be float32 or bfloat16, got "
                         f"{x_new.dtype}")
    d = x_new.shape[0]
    for arg, t in (("cluster_ids", cluster_ids), ("w_new", w_new),
                   ("w_old", w_old)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"{name}: {arg} must be [D]=[{d}], got shape "
                             f"{tuple(t.shape)}")
    if cluster_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: cluster_ids must be int32 or int64, got "
                         f"{cluster_ids.dtype}")
    if not (w_new.is_floating_point() and w_old.is_floating_point()):
        raise ValueError(f"{name}: w_new/w_old must be floating point")
    if num_segments < 1:
        raise ValueError(f"{name}: num_segments must be >= 1, got "
                         f"{num_segments}")
    device = backend.kernel_device(name, cluster_ids, w_new, w_old, x_new,
                                   x_old)
    backend.check_contiguous(name, cluster_ids=cluster_ids, w_new=w_new,
                             w_old=w_old, x_new=x_new, x_old=x_old)
    if device == "cpu" and d:
        lo, hi = torch.aminmax(cluster_ids)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= num_segments:
            raise ValueError(
                f"{name}: cluster_ids must lie in [0, num_segments="
                f"{num_segments}), got values in [{lo}, {hi}]")
    return device


def fed_mix_segment(cluster_ids: torch.Tensor, w_new: torch.Tensor,
                    w_old: torch.Tensor, x_new: torch.Tensor,
                    x_old: torch.Tensor, *, num_segments: int
                    ) -> torch.Tensor:
    """cluster_ids [D] int; w_new/w_old [D] float; x_new/x_old [D, P]
    f32 or bf16, contiguous -> [D, P] in x_new.dtype, f32 accumulation.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``fed_mix_segment.launches`` counts its launches); a bad cluster id is
    reported by ``check_cluster_ids``."""
    if _check(cluster_ids, w_new, w_old, x_new, x_old,
              num_segments) == "cpu":
        return ref.fed_mix_segment_ref(cluster_ids, w_new, w_old, x_new,
                                       x_old, num_segments=num_segments)
    d, p = x_new.shape
    out = torch.empty_like(x_new)
    if out.numel() == 0:
        return out
    ids = cluster_ids.to(torch.int32)
    wn = w_new.to(torch.float32)
    wo = w_old.to(torch.float32)
    needs_scratch = backend.c_function(
        "fed_mix_segment", "fed_mix_segment_needs_scratch", [ctypes.c_int])
    scratch = (torch.empty((num_segments, p), dtype=torch.float32,
                           device=x_new.device)
               if needs_scratch(num_segments) else None)
    launch = backend.c_function(
        "fed_mix_segment", "fed_mix_segment_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    rc = launch(ids.data_ptr(), wn.data_ptr(), wo.data_ptr(),
                x_new.data_ptr(), x_old.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                _bad_ids_flag(x_new.device).data_ptr(),
                d, p, num_segments, int(x_new.dtype == torch.bfloat16),
                backend.stream_ptr(x_new.device))
    backend.raise_on_error("fed_mix_segment", rc)
    fed_mix_segment.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
fed_mix_segment.launches = 0


# ---------------------------------------------------------------------------
# fed_mix_matching
# ---------------------------------------------------------------------------

def _check_matching(perms, survive, x_new, x_old) -> str:
    name = "fed_mix_matching"
    if x_new.dim() != 2:
        raise ValueError(f"{name}: x_new must be [D, P], got shape "
                         f"{tuple(x_new.shape)}")
    if x_new.shape != x_old.shape:
        raise ValueError(f"{name}: x_new {tuple(x_new.shape)} and x_old "
                         f"{tuple(x_old.shape)} differ in shape")
    if x_new.dtype != x_old.dtype:
        raise ValueError(f"{name}: x_new ({x_new.dtype}) and x_old "
                         f"({x_old.dtype}) differ in dtype")
    if x_new.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype must be float32 or bfloat16, got "
                         f"{x_new.dtype}")
    d = x_new.shape[0]
    if perms.dim() != 2 or perms.shape[1] != d:
        raise ValueError(f"{name}: perms must be [S, D]=[S, {d}], got shape "
                         f"{tuple(perms.shape)}")
    if perms.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: perms must be int32 or int64, got "
                         f"{perms.dtype}")
    if tuple(survive.shape) != (d,):
        raise ValueError(f"{name}: survive must be [D]=[{d}], got shape "
                         f"{tuple(survive.shape)}")
    device = backend.kernel_device(name, perms, survive, x_new, x_old)
    backend.check_contiguous(name, perms=perms, survive=survive,
                             x_new=x_new, x_old=x_old)
    if device == "cpu" and perms.numel():
        lo, hi = torch.aminmax(perms)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= d:
            raise ValueError(f"{name}: partner indices must lie in [0, D="
                             f"{d}), got values in [{lo}, {hi}]")
    return device


def fed_mix_matching(perms: torch.Tensor, survive: torch.Tensor,
                     x_new: torch.Tensor, x_old: torch.Tensor
                     ) -> torch.Tensor:
    """perms [S, D] int (stage partner maps, perm[i] = i for byes);
    survive [D] 0/1; x_new/x_old [D, P] f32 or bf16, contiguous -> [D, P]
    in x_new.dtype, f32 in between.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``fed_mix_matching.launches`` counts its calls); there a partner
    index outside [0, D) gives a NaN row instead of an error, as the
    indices are not read back."""
    if _check_matching(perms, survive, x_new, x_old) == "cpu":
        return ref.fed_mix_matching_ref(perms, survive, x_new, x_old)
    d, p = x_new.shape
    out = torch.empty_like(x_new)
    if out.numel() == 0:
        return out
    stages = perms.shape[0]
    pm = perms.to(torch.int32)
    sv = survive.to(torch.float32)
    n_scratch = backend.c_function(
        "fed_mix_matching", "fed_mix_matching_scratch_buffers",
        [ctypes.c_int, ctypes.c_int])(d, stages)
    scratch = (torch.empty((n_scratch, d, p), dtype=torch.float32,
                           device=x_new.device) if n_scratch else None)
    launch = backend.c_function(
        "fed_mix_matching", "fed_mix_matching_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    rc = launch(pm.data_ptr(), sv.data_ptr(), x_new.data_ptr(),
                x_old.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                d, p, stages, int(x_new.dtype == torch.bfloat16),
                backend.stream_ptr(x_new.device))
    backend.raise_on_error("fed_mix_matching", rc)
    fed_mix_matching.launches += 1
    return out


#: kernel calls since the last reset (CPU calls do not count)
fed_mix_matching.launches = 0
