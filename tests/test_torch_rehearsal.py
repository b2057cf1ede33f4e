"""CPU rehearsal of the arithmetic of two of the port's CUDA kernels,
against the JAX package. The kernels run only on a card
(``tests/test_torch_cuda.py``); these tests run their decompositions in
plain PyTorch on the CPU.

* ``ssd_scan`` (``kernels/csrc/ssd_scan.cu``) runs Mamba-2's chunked scan
  as three passes: each chunk's own state (``chunk_states``), the
  recurrence of the [p, n] state across chunks (``carry``), and the output
  from the chunk's incoming state and its causal block (``chunk_outputs``).
  Written out here pass by pass in f32, it is held against the port's
  plain version (``ref.ssd_chunked``), the JAX Pallas kernel in interpret
  mode (zero initial state) and the JAX model's ``ssd_chunked`` (with an
  initial state) over ``test_torch_lm_kernels.py``'s sweep, at the card's
  tolerance: rtol 1e-4 and an atol of 5e-4 of the reference's largest
  value (the cumsum of dt·A is taken in another order, and exp of its
  differences carries ~1e-5 of relative error in either order).
* ``fed_mix_q`` (``kernels/csrc/fed_mix_q.cu``) folds the int8 record's
  scale into the A operand where a warp's 32 columns lie in one scale
  chunk: M_new · s[:, c] is split into TF32 hi/lo, and float(q), exact in
  TF32, takes two products, (lo + hi) · q. Emulated with the split of
  ``test_torch_tf32x3.py``, held against the JAX Pallas ``fed_mix_q`` in
  interpret mode at 1e-5 (the JAX kernel tests' tolerance), for chunks
  that are multiples of 32.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression import Int8Codec as JInt8Codec  # noqa: E402
from repro.kernels.fed_mix_q import fed_mix_q as jax_fed_mix_q  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_tf32x3 import split  # noqa: E402

F32 = torch.float32


# ---------------------------------------------------------------------------
# ssd_scan: the three passes
# ---------------------------------------------------------------------------

def chunk_states(x, dt, A, B, q):
    """Pass 1: a = cumsum(dt A) within each chunk, and each chunk's own
    state Σ_s (x_s dt_s exp(a_last - a_s)) ⊗ B_s -> (local [b, h, nc, p, n],
    a [b, h, nc, q])."""
    b, s, h, p = x.shape
    nc = s // q
    a = torch.cumsum((dt * A).reshape(b, nc, q, h).permute(0, 3, 1, 2), -1)
    w = dt.reshape(b, nc, q, h).permute(0, 3, 1, 2) * torch.exp(
        a[..., -1:] - a)                                       # [b,h,c,q]
    xw = x.reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4) * w[..., None]
    local = torch.einsum("bhcsp,bcsn->bhcpn", xw,
                         B.reshape(b, nc, q, -1))
    return local, a


def carry(local, a, init):
    """Pass 2: state_c = state_{c-1} exp(a_last, c-1) + local_{c-1}, a
    rounded product then a rounded sum -> (the state entering each chunk
    [b, h, nc, p, n], the final state)."""
    state = init
    states_in = []
    for c in range(local.shape[2]):
        states_in.append(state)
        state = state * torch.exp(a[:, :, c, -1])[..., None, None] \
            + local[:, :, c]
    return torch.stack(states_in, 2), state


def chunk_outputs(x, dt, B, C, a, states_in, q):
    """Pass 3: y_l = exp(a_l) (C_l · state_c) + Σ_{s<=l} (C_l·B_s)
    exp(a_l - a_s) dt_s x_s."""
    b, s, h, p = x.shape
    nc = s // q
    cc = C.reshape(b, nc, q, -1)
    bc = B.reshape(b, nc, q, -1)
    off = torch.einsum("bcln,bhcpn->bhclp", cc, states_in) * torch.exp(
        a)[..., None]
    g = torch.einsum("bcln,bcsn->bcls", cc, bc)                # [b,c,l,s]
    decay = torch.exp(a[..., :, None] - a[..., None, :])       # [b,h,c,l,s]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    gd = torch.where(causal, g[:, None] * decay, torch.zeros(()))
    gd = gd * dt.reshape(b, nc, q, h).permute(0, 3, 1, 2)[..., None, :]
    xs = x.reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    y = off + torch.einsum("bhcls,bhcsp->bhclp", gd, xs)
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


def three_pass(x, dt, A, B, C, q, init=None):
    b, _, h, p = x.shape
    init = (torch.zeros((b, h, p, B.shape[-1]), dtype=F32) if init is None
            else init)
    local, a = chunk_states(x, dt, A, B, q)
    states_in, final = carry(local, a, init)
    return chunk_outputs(x, dt, B, C, a, states_in, q), final


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _close_card(got, want):
    """The card's tolerance of ssd_scan against its plain version."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=5e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 3, 16, 32, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 64, 1, 8, 16, 16),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_three_passes_match_reference(b, s, h, p, n, chunk, with_state):
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=s + n)
    init = (np.random.default_rng(5).standard_normal((b, h, p, n))
            .astype(np.float32) if with_state else None)
    tx, tdt, tA, tB, tC = (torch.from_numpy(v) for v in (x, dt, A, B, C))
    tinit = None if init is None else torch.from_numpy(init)
    y, st = three_pass(tx, tdt, tA, tB, tC, chunk, tinit)
    y_ref, st_ref = ref.ssd_chunked(tx, tdt, tA, tB, tC, chunk,
                                    initial_state=tinit)
    _close_card(y.numpy(), y_ref.numpy())
    _close_card(st.numpy(), st_ref.numpy())
    jargs = [jnp.asarray(v) for v in (x, dt, A, B, C)]
    if init is None:
        y_pl, st_pl = jax_ssd(*jargs, chunk=chunk, interpret=True)
    else:
        y_pl, st_pl = jax_ssd_chunked(*jargs, chunk,
                                      initial_state=jnp.asarray(init))
    _close_card(y.numpy(), y_pl)
    _close_card(st.numpy(), st_pl)


# ---------------------------------------------------------------------------
# fed_mix_q: the scale folded into the A operand
# ---------------------------------------------------------------------------

def folded_mix_q(mn, mo, q, sc, xo, chunk):
    """The kernel's arithmetic at a chunk that is a multiple of 32: for each
    scale chunk c, A' = M_new · s[:, c] split into hi/lo against float(q)
    (exact, lo = 0): (lo + hi) · q; then M_old · X_old as three split
    products."""
    d, p = xo.shape
    qf = q.to(F32)
    out = torch.empty((d, p), dtype=F32)
    for c0 in range(0, p, chunk):
        cols = slice(c0, min(c0 + chunk, p))
        ah, al = split(mn * sc[:, c0 // chunk][None, :])
        out[:, cols] = al @ qf[:, cols] + ah @ qf[:, cols]
    mh, ml = split(mo)
    xh, xl = split(xo)
    return out + (ml @ xh + mh @ xl + mh @ xh)


@pytest.mark.parametrize("d,p,chunk", [(6, 700, 256), (16, 4096, 256),
                                       (17, 513, 128), (1, 129, 64),
                                       (100, 1000, 256), (40, 300, 32)])
def test_fed_mix_q_folded_split_matches_pallas(d, p, chunk):
    rng = np.random.default_rng(d * p)
    mn, mo = rng.uniform(0, 1, (d, d)), rng.uniform(0, 1, (d, d))
    tot = (mn + mo).sum(axis=1, keepdims=True)
    mn, mo = (mn / tot).astype(np.float32), (mo / tot).astype(np.float32)
    x = rng.normal(size=(d, p)).astype(np.float32)
    xo = rng.normal(size=(d, p)).astype(np.float32)
    enc = JInt8Codec(chunk=chunk).encode(jnp.asarray(x),
                                         key=jax.random.PRNGKey(0))
    q, sc = np.array(enc.values), np.array(enc.scales)
    got = folded_mix_q(*(torch.from_numpy(v) for v in (mn, mo, q, sc, xo)),
                       chunk=chunk)
    want = jax_fed_mix_q(*(jnp.asarray(v) for v in (mn, mo, q, sc, xo)),
                         chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
