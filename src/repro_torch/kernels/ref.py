"""Plain PyTorch versions of the port's kernels (the counterpart of
``repro.kernels.ref``).

Each function computes what its CUDA kernel computes, with stock tensor
ops: the wrappers take it for CPU tensors, the CPU tests hold it against
the JAX package, and ``chip_smoke.py`` holds each kernel against it on the
card. It is not used on the main path when a card is present. On CUDA its
matmuls need TF32 off (``backend.use_full_f32``), as the reference is full
f32.
"""
from __future__ import annotations

import torch


def fed_mix_ref(m_new: torch.Tensor, m_old: torch.Tensor,
                x_new: torch.Tensor, x_old: torch.Tensor) -> torch.Tensor:
    """m_new, m_old: [D, D]; x_new, x_old: [D, P] -> [D, P].

    The dense mixing operator f_out = M_new @ f_new + M_old @ f_old on
    flat-packed client params (f32 accumulate, cast back to x_new.dtype).
    """
    f32 = torch.float32
    out = m_new.to(f32) @ x_new.to(f32)
    out = out + m_old.to(f32) @ x_old.to(f32)
    return out.to(x_new.dtype)


def fed_mix_segment_ref(cluster_ids: torch.Tensor, w_new: torch.Tensor,
                        w_old: torch.Tensor, x_new: torch.Tensor,
                        x_old: torch.Tensor, *, num_segments: int
                        ) -> torch.Tensor:
    """cluster_ids: [D] int; w_new, w_old: [D]; x_new, x_old: [D, P];
    num_segments: L -> [D, P].

    Per-cluster sums of the weighted rows, gathered back to every member
    row —

        out_i = sum_{j: c(j)=c(i)} (w_new_j x_new_j + w_old_j x_old_j)

    — f32 accumulate, cast back to x_new.dtype.
    """
    f32 = torch.float32
    ids = cluster_ids.long()
    y = (w_new.to(f32)[:, None] * x_new.to(f32)
         + w_old.to(f32)[:, None] * x_old.to(f32))
    seg = y.new_zeros((num_segments, y.shape[1])).index_add_(0, ids, y)
    return seg[ids].to(x_new.dtype)


def fed_mix_matching_ref(perms: torch.Tensor, survive: torch.Tensor,
                         x_new: torch.Tensor, x_old: torch.Tensor
                         ) -> torch.Tensor:
    """perms: [S, D] int stage partner indices (perm[i] = i for byes);
    survive: [D] 0/1; x_new, x_old: [D, P] -> [D, P].

    Stragglers contribute their OLD row, then each stage averages every
    row with its partner row —

        eff = s·x_new + (1-s)·x_old;  eff = ½(eff + eff[perm_s])  per stage

    — f32 accumulate, cast back to x_new.dtype.
    """
    f32 = torch.float32
    s = survive.to(f32)[:, None]
    eff = s * x_new.to(f32) + (1.0 - s) * x_old.to(f32)
    for i in range(perms.shape[0]):
        eff = 0.5 * (eff + eff[perms[i].long()])
    return eff.to(x_new.dtype)


def fed_mix_q_ref(m_new: torch.Tensor, m_old: torch.Tensor,
                  q_new: torch.Tensor, scales: torch.Tensor,
                  x_old: torch.Tensor, *, chunk: int = 256,
                  out_dtype=None) -> torch.Tensor:
    """m_new, m_old: [D, D]; q_new: int8 [D, Pq] (Pq a multiple of chunk);
    scales: f32 [D, Pq/chunk]; x_old: [D, P], P <= Pq -> [D, P].

    Dequantize the int8 record (one absmax scale per chunk), then the
    dense f32 mix; the output is ``out_dtype`` or x_old's dtype.
    """
    f32 = torch.float32
    d, n = q_new.shape[0], x_old.shape[1]
    v = q_new.to(f32).reshape(d, -1, chunk)
    xn = (v * scales.to(f32)[..., None]).reshape(d, -1)[:, :n]
    out = m_new.to(f32) @ xn
    out = out + m_old.to(f32) @ x_old.to(f32)
    return out.to(x_old.dtype if out_dtype is None else out_dtype)


def fed_aggregate_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [N, D]; w: [N] -> [D]: out[d] = sum_n w[n] x[n, d], f32
    accumulate, cast back to x.dtype."""
    f32 = torch.float32
    return torch.einsum("n,nd->d", w.to(f32), x.to(f32)).to(x.dtype)


# ---------------------------------------------------------------------------
# the LM kernels
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, num_meta: int = 0
                        ) -> torch.Tensor:
    """q [B, Hq, Sq, hd]; k [B, Hkv, T, hd]; v [B, Hkv, T, vd] ->
    [B, Hq, Sq, vd] (vd = hd, or v's own head_dim: MLA's q/k 192, v 128).

    Dense causal softmax attention in f32 (query head h reads kv head
    h // G), scaled by ``hd ** -0.5`` of q's and k's head_dim (as the JAX
    package's ``_direct_attention``), positions 0..Sq-1 and 0..T-1: key j
    is visible to query i when j <= i and, for ``window > 0``, i - j <
    window or j < num_meta (the pinned meta tokens). Masked scores are
    -1e30. Cast back to q.dtype.
    """
    f32 = torch.float32
    sq, hd = q.shape[2], q.shape[3]
    tk = k.shape[2]
    g = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).to(f32)
    vv = v.repeat_interleave(g, dim=1).to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kk) * hd ** -0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(tk, device=q.device)[None, :]
    mask = kp <= qp
    if window > 0:
        mask &= ((qp - kp) < window) | (kp < num_meta)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def ssd_scan_ref(x, dt, A, B, C):
    """The naive sequential SSD recurrence (the ground truth of both the
    chunked form and the kernel), from a zero state:
    x [b,S,h,p], dt [b,S,h], A [h], B/C [b,S,n] -> (y in x's dtype,
    final_state [b,h,p,n] f32)."""
    f32 = torch.float32
    b, s, h, p = x.shape
    n = B.shape[-1]
    out_dtype = x.dtype
    x, dt, A, B, C = (t.to(f32) for t in (x, dt, A, B, C))
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None, :])                 # [b,h]
        upd = torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                           B[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, h, p))
    return y.to(out_dtype), state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T] lower-triangular segment sums (diagonal
    included), -inf above the diagonal."""
    t = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    z = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return z.masked_fill(~mask, float("-inf"))


def _exp_ftz(z: torch.Tensor) -> torch.Tensor:
    """exp with subnormal results flushed to 0, as XLA computes it on the
    CPU and the TPU: where a decay underflows, an inf times it is NaN, as
    in the JAX kernel. Out of place, so that autograd can go through it,
    and a product with a 0/1 mask, so that a flushed entry's gradient is
    g · 0 as XLA's flushed exp gives: 0 for a finite g, NaN for an inf or
    NaN one (a select would give 0 for every g)."""
    e = torch.exp(z)
    return e * (e >= torch.finfo(e.dtype).tiny).to(e.dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """The chunked SSD (``models/ssm.py`` ssd_chunked in the JAX package):
    quadratic attention-like products inside each chunk of ``chunk``
    positions plus a sequential recurrence of the state between chunks.

    x [b,S,h,p], dt [b,S,h] (post-softplus), A [h] (< 0), B, C [b,S,n],
    S a multiple of chunk, initial_state [b,h,p,n] or None (zeros) ->
    (y [b,S,h,p] in x's dtype, final_state [b,h,p,n] f32). It computes in
    f32, or in f64 for f64 inputs (a reference for the f32 versions). The
    decays exp(·) flush subnormal results to 0, as XLA does.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} must divide S={s}")
    q, nc = chunk, s // chunk
    f32 = torch.promote_types(x.dtype, torch.float32)
    xd = (x * dt[..., None]).to(f32).reshape(b, nc, q, h, p)
    a_dt = (dt * A[None, None, :]).to(f32).reshape(b, nc, q, h)
    a_dt = a_dt.permute(0, 3, 1, 2)                           # [b,h,c,q]
    bc = B.to(f32).reshape(b, nc, q, n)
    cc = C.to(f32).reshape(b, nc, q, n)

    # Every product is taken in the order in which XLA contracts the JAX
    # package's einsums (C·Bᵀ, times the decay mask L, times x·dt;
    # decay·x·dt, times B; C·decay, times the state), one pair of operands
    # at a time, so that inf and NaN come out where the JAX kernel and
    # jax.grad give them: a 0 of L above the diagonal times an inf of C·Bᵀ
    # or of x·dt is NaN there, and each gradient sums the same partial
    # products (an inf in B makes Σ_p of decay·x·dt·dstate NaN).
    a_cum = torch.cumsum(a_dt, dim=-1)                        # [b,h,c,q]
    L = _exp_ftz(_segsum(a_dt))                               # [b,h,c,q,q]
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * L, xd)

    decay_states = _exp_ftz(a_cum[..., -1:] - a_cum)          # [b,h,c,q]
    states = torch.einsum("bcshp,bcsn->bchpn",
                          decay_states.permute(0, 2, 3, 1)[..., None] * xd,
                          bc)
    chunk_decay = _exp_ftz(a_cum[..., -1])                    # [b,h,c]

    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    states_in = []
    for c in range(nc):                          # the state ENTERING chunk c
        states_in.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, c]
    states_in = torch.stack(states_in, dim=1)                 # [b,c,h,p,n]

    state_decay = _exp_ftz(a_cum)                             # [b,h,c,q]
    y_off = torch.einsum("bclhn,bchpn->bclhp",
                         cc[:, :, :, None] * state_decay.permute(0, 2, 3, 1)[
                             ..., None], states_in)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state
