"""The dense round engine of the port (the counterpart of ``mix_flat``,
``make_local_trainer`` and ``DenseEngine`` in ``repro.protocols.engine``).

One round (``DenseEngine._round_rows`` + the consensus collapse):

  1. partition  — the protocol picks P participants and their clusters;
  2. stragglers — a survive mask;
  3. local SGD  — all P clients at once (a hand-batched forward, autograd
     over the sum of the per-client losses, which gives each client's own
     gradient);
  4. mixing     — the protocol's structured spec through its kernel
     (``SegmentSpec``: ``fed_mix_segment``; ``MatchingSpec``:
     ``fed_mix_matching``), or on ``mix_path="dense"`` its
     ``(M_new, M_old)`` through ``fed_mix``; with a ``codec`` the round
     delta crosses the lossy wire first (int8 on the dense path contracts
     the int8 record in ``fed_mix_q``); with ``sync_period > 1`` the
     intermediate sub-rounds mix WITHOUT the global step;
  5. collapse   — the reported global model is ``mean_packed`` over the
     mixed client rows;
  6. evaluation.

With a fault plan (``faults=``, ``repro_torch.faults``) a round also
drops the plan's clients from the survive mask, poisons its flagged
uploads, takes non-finite or flagged rows out of the mix and runs the
scatter-back guard after it; ``run_rounds`` then counts ``dropped`` and
``rejected_rows`` per round. With ``faults=None`` none of this runs.

The federated state is one packed [P, sum(sizes)] buffer for the whole
round (``kernels.ops.pack_tree`` layout); a stateful codec's
error-feedback residual is one more [P, sum(sizes)] f32 buffer, carried
across the rounds of a ``run_rounds``. A round's randomness is drawn up
front into a ``RoundDraws`` record from a ``torch.Generator`` on the
engine's device; a caller may hand the records in instead, which is how
the parity tests give this engine and the JAX one the same draws. Metrics
stay on the device as [T] tensors for the whole ``run_rounds``: nothing in
the round loop reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import compression
from repro_torch import faults as fault_lib
from repro_torch.config import FLConfig
from repro_torch.configs.paper_models import PaperNetConfig
from repro_torch.core.straggler import straggler_mask
from repro_torch.core.topology import Topology
from repro_torch.kernels import backend
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.paper_nets import (
    init_paper_net, paper_net_correct, paper_net_loss_batched,
)
from repro_torch.protocols.base import Protocol
from repro_torch.protocols.context import make_context
from repro_torch.protocols.spec import apply_spec_flat

MIX_PATHS = ("dense", "sparse", "auto")


def _check_mix_path(mix_path: str) -> str:
    if mix_path not in MIX_PATHS:
        raise ValueError(f"unknown mix_path {mix_path!r}; expected one of "
                         f"{', '.join(MIX_PATHS)}")
    return mix_path


def _resolve_spec(proto: Protocol, ctx, mix_path: str):
    """The protocol's structured MixingSpec unless the path is 'dense';
    'sparse' refuses to fall back when no spec exists."""
    if mix_path == "dense":
        return None
    spec = proto.mixing_spec(ctx)
    if spec is None and mix_path == "sparse":
        raise ValueError(
            f"protocol {proto.name!r} provides no mixing_spec; "
            "mix_path='sparse' is unavailable (use 'auto' or 'dense')")
    return spec


def mix_flat(proto: Protocol, flat_new, flat_old, ctx, codec_state, *,
             mix_path: str, codec, u=None):
    """One mixing application on a packed [P, sum(sizes)] buffer: the
    structured-spec kernel on the sparse path, the dense (M_new, M_old)
    kernel otherwise; the codec wire (``u``: the int8 codec's rounding
    noise) sits identically in front of both. Always returns ``(flat,
    codec_state)``."""
    spec = _resolve_spec(proto, ctx, mix_path)
    if spec is not None:
        if codec is None:
            return apply_spec_flat(spec, flat_new, flat_old), codec_state
        return apply_spec_flat(spec, flat_new, flat_old, codec=codec,
                               codec_state=codec_state, u=u)
    M_new, M_old = proto.mixing_matrix(ctx)
    if codec is None:
        return (kernel_ops.fed_mix_flat(M_new, M_old, flat_new, flat_old),
                codec_state)
    return kernel_ops.fed_mix_flat(M_new, M_old, flat_new, flat_old,
                                   codec=codec, codec_state=codec_state,
                                   u=u)


# ---------------------------------------------------------------------------
# Client-local training, batched over the round's participants
# ---------------------------------------------------------------------------

def make_local_trainer(net: PaperNetConfig, fl: FLConfig):
    """Returns f(params, cx, cy, cmask, perms) -> (params', mean_loss) for P
    clients at once: ``params`` leaves [P, ...] (not modified), ``cx``
    [P, n_max, ...], ``cy``/``cmask`` [P, n_max], ``perms`` [P, E, n_max]
    each epoch's sample order. Each client runs E epochs of
    ceil(n_max / bs) SGD steps over its padded block, batch s of an epoch
    being ``perm[(arange(bs) + s·bs) % n_max]``; the loss is the masked
    mean, averaged over the steps."""
    bs = fl.batch_size

    def local_train(params, cx, cy, cmask, perms):
        P, n_max = cy.shape
        steps = max(1, -(-n_max // bs))               # ceil
        dev = cy.device
        rows = torch.arange(P, device=dev)[:, None]
        offsets = torch.arange(steps * bs, device=dev).reshape(steps, bs)
        offsets = offsets % n_max
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        leaves = list(params.values())
        loss_sum = torch.zeros((P,), dtype=torch.float32, device=dev)
        cnt = 0
        for e in range(perms.shape[1]):
            perm = perms[:, e]
            for s in range(steps):
                idx = perm[:, offsets[s]]                     # [P, bs]
                batch = {"x": cx[rows, idx], "y": cy[rows, idx],
                         "mask": cmask[rows, idx]}
                loss = paper_net_loss_batched(params, batch, net)   # [P]
                # per-client losses are independent, so the gradient of
                # their sum is every client's own gradient
                grads = torch.autograd.grad(loss.sum(), leaves)
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        p.sub_(fl.lr * g.to(p.dtype))
                loss_sum = loss_sum + loss.detach()
                cnt += 1
        return ({k: v.detach() for k, v in params.items()},
                loss_sum / max(cnt, 1))

    return local_train


# ---------------------------------------------------------------------------
# One round's randomness
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RoundDraws:
    """Every random draw of one round: ``sel`` [P] int64 participants,
    ``cluster_ids`` [P] int32, ``survive`` [P] f32 straggler mask,
    ``batch_perm`` [sub_rounds, P, E, n_max] int64 — the sample order of
    every client's every epoch in every sub-round. Mix r (r = 1 ..
    sub_rounds) reads entry r-1 of the two optional fields: ``matching``
    [sub_rounds] int64, the matching index of a protocol that draws one
    (gossip_async), and ``wire_noise`` [sub_rounds, P, n_pad] f32, the
    int8 codec's stochastic-rounding noise (n_pad = sum(sizes) rounded up
    to the codec's chunk). The engine moves them to its device."""
    sel: torch.Tensor
    cluster_ids: torch.Tensor
    survive: torch.Tensor
    batch_perm: torch.Tensor
    matching: Optional[torch.Tensor] = None
    wire_noise: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Dense engine
# ---------------------------------------------------------------------------

class DenseEngine:
    """Drives one protocol's rounds on the paper's own model classes
    (§4.2) on a PACKED federated state (see the module docstring).

    ``device=None`` means the card (and raises where there is none);
    ``device="cpu"`` runs the kernels' plain versions. ``codec`` is a
    ``repro_torch.compression`` name or Codec (``None``/``"none"`` runs
    the codec-free program). ``topology`` (a ``core.topology.Topology``)
    reaches the protocol's ``partition`` and every ``RoundContext``.
    ``faults`` is a ``repro_torch.faults.FaultPlan``; ``None`` or an empty
    plan runs the fault-free program."""

    def __init__(self, net: PaperNetConfig, data_dev: Dict, fl: FLConfig,
                 proto: Protocol, topology: Optional[Topology] = None, *,
                 codec=None, mix_path: Optional[str] = None, faults=None,
                 device=None):
        self.net, self.fl, self.proto = net, fl, proto
        self.topology = topology
        #: the fault plan in active form (None: the fault-free program)
        self.faults = fault_lib.active(faults)
        self.device = backend.resolve_device(device)
        self.data_dev = {k: v.to(self.device) for k, v in data_dev.items()}
        self.mix_path = _check_mix_path(mix_path or fl.mix_path)
        self.codec = compression.active(codec)
        #: the int8 record's padded width, for the rounding-noise draw
        self._n_pad = None
        if isinstance(self.codec, compression.Int8Codec):
            n = sum(v.numel() for v in init_paper_net(
                torch.Generator(), net).values())
            self._n_pad = self.codec.padded(n)
        self._train = make_local_trainer(net, fl)

    # -- randomness --------------------------------------------------------
    def draw_round(self, gen: torch.Generator) -> RoundDraws:
        """One round's draws from ``gen`` (on the engine's device)."""
        fl = self.fl
        P = self.proto.num_participants(fl)
        sel, cids = self.proto.partition(gen, fl, self.topology)
        survive = straggler_mask(gen, P, fl.straggler_rate)
        n_max = self.data_dev["y"].shape[1]
        subs = max(1, fl.sync_period)
        u = torch.rand((subs, P, fl.local_epochs, n_max), generator=gen,
                       device=gen.device)
        R = self.proto.num_matchings(fl)
        matching = (torch.randint(0, R, (subs,), generator=gen,
                                  device=gen.device) if R else None)
        noise = (torch.rand((subs, P, self._n_pad), generator=gen,
                            device=gen.device)
                 if self._n_pad is not None else None)
        return RoundDraws(sel=sel, cluster_ids=cids, survive=survive,
                          batch_perm=u.argsort(dim=-1), matching=matching,
                          wire_noise=noise)

    # -- evaluation --------------------------------------------------------
    def evaluate(self, params):
        """(sample-weighted acc, client-mean acc) of one global model over
        every client's test split, as two 0-d device tensors."""
        tx, ty = self.data_dev["test_x"], self.data_dev["test_y"]
        tm = self.data_dev["test_mask"]
        N, n_te = ty.shape
        # one model over all N clients' samples: the P = 1 batched call
        batch = {"x": tx.reshape((1, N * n_te) + tuple(tx.shape[2:])),
                 "y": ty.reshape(1, N * n_te),
                 "mask": tm.reshape(1, N * n_te)}
        with torch.no_grad():
            correct = paper_net_correct({k: v[None] for k, v in
                                         params.items()}, batch, self.net)
        m = tm.to(torch.float32)
        ns = m.sum(dim=-1)
        accs = ((correct.reshape(N, n_te) * m).sum(dim=-1)
                / torch.clamp_min(ns, 1.0))
        sample_weighted = (accs * ns).sum() / torch.clamp_min(ns.sum(), 1.0)
        return sample_weighted, accs.mean()

    # -- packed-state helpers ----------------------------------------------
    def _pack_params(self, params):
        """Pack ONE global model into its flat [sum(sizes)] row + the
        TreeSpec that unpacks any [..., sum(sizes)] buffer."""
        flat, spec = kernel_ops.pack_tree({k: v[None] for k, v in
                                           params.items()})
        return flat[0], spec

    def _mix_flat(self, flat_new, flat_old, ctx, cstate, u=None):
        return mix_flat(self.proto, flat_new, flat_old, ctx, cstate,
                        mix_path=self.mix_path, codec=self.codec, u=u)

    def _init_codec_state_flat(self, flat):
        """The zero error-feedback residual of a stateful codec: one f32
        row per participant slot over the packed width; None otherwise."""
        if self.codec is None or not self.codec.stateful:
            return None
        P = self.proto.num_participants(self.fl)
        return torch.zeros((P, flat.shape[-1]), dtype=torch.float32,
                           device=flat.device)

    # -- one round -----------------------------------------------------------
    def _round_rows(self, spec, flat_params, draws: RoundDraws,
                    round_index: int = 0, codec_state=None, fault=None):
        """One protocol round on the packed carry, stopping BEFORE the
        consensus collapse: ``flat_params`` is the flat [sum(sizes)] global
        model, ``spec`` its TreeSpec. Returns the mixed PER-CLIENT rows
        ``(flat_mixed [P, sum(sizes)], losses [P], codec_state)``;
        ``losses`` are the last sub-round's, ``codec_state`` the threaded
        error-feedback residual (None without a stateful codec).

        ``fault`` (active plans only) is this round's ``(drop [P], flag
        [P], mode [P])`` from ``FaultPlan.dense_arrays``, on the engine's
        device: dropped clients leave the survive mask for every
        sub-round, flagged clients' FINAL uploads are poisoned
        (``corrupt_flat``), rows that are non-finite or flagged are taken
        out of the mix like stragglers and their bytes replaced with the
        round-start row (a masked NaN row would still poison a dense
        product through 0 · nan), and the scatter-back guard reverts any
        rejected row to its round-start value. The return then grows a
        4th element: ``{'dropped', 'rejected_rows'}`` 0-d int32 counters."""
        proto, fl, data = self.proto, self.fl, self.data_dev
        P = proto.num_participants(fl)
        L = proto.num_clusters(fl)
        sel, cids, survive, perms = (t.to(self.device) for t in (
            draws.sel, draws.cluster_ids, draws.survive, draws.batch_perm))
        drop = flag = mode = None
        if fault is not None:
            drop, flag, mode = fault
            survive = survive * (1.0 - drop)
        # gathered ONCE per round: the selection is fixed across sub-rounds
        cx, cy, cm = data["x"][sel], data["y"][sel], data["mask"][sel]
        counts = data["counts"][sel]
        # the round-start state of every participant (contiguous: the
        # kernels take dense [P, sum(sizes)] buffers)
        flat_old = flat_params[None].expand(P, -1).contiguous()

        matching, noise = (None if t is None else t.to(self.device)
                           for t in (draws.matching, draws.wire_noise))

        def mix(flat_new, r: int, sync: bool, cstate, mask=survive):
            """Mix r (1-based): its matching and rounding noise are entry
            r-1 of the round's draws."""
            ctx = make_context(
                round_index=round_index, survive=mask, counts=counts,
                cluster_ids=cids, num_clusters=L, do_global_sync=sync,
                matching=None if matching is None else matching[r - 1],
                topology=self.topology, fault_drop=drop)
            return self._mix_flat(flat_new, flat_old, ctx, cstate,
                                  u=None if noise is None else noise[r - 1])

        flat_cp = losses = None
        cstate = codec_state
        subs = max(1, fl.sync_period)
        for r in range(subs):
            if flat_cp is None:
                start = flat_old
            else:
                start, cstate = mix(flat_cp, r, False, cstate)
            cp, losses = self._train(kernel_ops.unpack_tree(start, spec),
                                     cx, cy, cm, perms[r])
            flat_cp = kernel_ops.pack_tree(cp)[0]
        if fault is None:
            flat_mixed, cstate = mix(flat_cp, subs, True, cstate)
            return flat_mixed, losses, cstate
        # the fault wire sits on the FINAL upload: poison flagged rows,
        # then the receive side's check — finite and not flagged (a
        # bit-flipped row stays finite; without the flag its huge values
        # would enter every other row's average)
        flat_cp = fault_lib.corrupt_flat(flat_cp, flag, mode)
        ok = torch.isfinite(flat_cp).all(dim=1) & (flag <= 0)
        flat_cp = torch.where(ok[:, None], flat_cp, flat_old)
        flat_mixed, cstate = mix(flat_cp, subs, True, cstate,
                                 mask=survive * ok.to(survive.dtype))
        guarded, bad = fault_lib.guard_flat(flat_mixed, flat_old, flag)
        counters = {"dropped": drop.sum().to(torch.int32),
                    "rejected_rows": bad.sum().to(torch.int32)}
        return guarded, losses, cstate, counters

    def _round_flat(self, spec, flat_params, draws: RoundDraws,
                    round_index: int = 0, codec_state=None, fault=None):
        """``_round_rows`` + the consensus collapse: the global model is
        the mean over the mixed client rows, each leaf in its own dtype
        (``mean_packed``). Returns ``(flat', mean_loss, codec_state)``;
        with ``fault`` the round's counter dict rides along as the last
        element."""
        out = self._round_rows(spec, flat_params, draws, round_index,
                               codec_state, fault=fault)
        flat_mixed, losses, cstate = out[:3]
        return (kernel_ops.mean_packed(flat_mixed, spec), losses.mean(),
                cstate) + out[3:]

    # -- the training loop ---------------------------------------------------
    def run_rounds(self, params, gen: Optional[torch.Generator], T: int,
                   eval_every: int = 1, *,
                   draws: Optional[Sequence[RoundDraws]] = None):
        """Run T rounds over the PACKED carry: the global model is packed
        once, every round works on flat buffers, and the final model is
        unpacked once. Round t's randomness is ``draws[t]`` when given,
        else drawn from ``gen``. Returns (final_params, metrics) with
        metrics = {'train_loss', 'acc', 'acc_client_mean'}, each a [T]
        tensor on the engine's device — nothing is read back to the host.
        Under a fault plan the metrics grow the four [T] int32 fault
        counters: ``dropped``, ``rejected_rows``, and ``retries`` and
        ``prefetch_fallbacks`` as zeros (store-tier counters; this engine
        has no store).
        With ``eval_every > 1`` the accuracy entries are computed only at
        rounds where (t+1) % eval_every == 0 and at the last round; the
        other slots are zeros the caller must not read. A stateful codec's
        error-feedback residual is per-run memory: zeros at the start of
        each call, carried from round to round."""
        T, eval_every = int(T), max(1, int(eval_every))
        if draws is None and gen is None:
            raise ValueError("run_rounds needs a generator or explicit "
                             "draws")
        if draws is not None and len(draws) < T:
            raise ValueError(f"run_rounds: {len(draws)} RoundDraws for "
                             f"T={T} rounds")
        flat, spec = self._pack_params(params)
        cstate = self._init_codec_state_flat(flat)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss: List[torch.Tensor] = []
        acc_w: List[torch.Tensor] = []
        acc_m: List[torch.Tensor] = []
        fault_xs = counters = None
        if self.faults is not None:
            P = self.proto.num_participants(self.fl)
            fault_xs = [torch.from_numpy(a).to(self.device)
                        for a in self.faults.dense_arrays(T, P)]
            counters = {"dropped": [], "rejected_rows": []}
        for t in range(T):
            d = draws[t] if draws is not None else self.draw_round(gen)
            fault = None if fault_xs is None else [a[t] for a in fault_xs]
            out = self._round_flat(spec, flat, d, t, cstate, fault=fault)
            flat, round_loss, cstate = out[:3]
            if fault is not None:
                for k in counters:
                    counters[k].append(out[3][k])
            loss.append(round_loss)
            if (t + 1) % eval_every == 0 or t == T - 1:
                a_w, a_m = self.evaluate(kernel_ops.unpack_tree(flat, spec))
            else:
                a_w, a_m = zero, zero
            acc_w.append(a_w)
            acc_m.append(a_m)
        metrics = {"train_loss": torch.stack(loss), "acc": torch.stack(acc_w),
                   "acc_client_mean": torch.stack(acc_m)}
        if counters is not None:
            zeros = torch.zeros((T,), dtype=torch.int32, device=self.device)
            metrics.update({k: torch.stack(v) for k, v in counters.items()},
                           retries=zeros, prefetch_fallbacks=zeros.clone())
        return kernel_ops.unpack_tree(flat, spec), metrics
