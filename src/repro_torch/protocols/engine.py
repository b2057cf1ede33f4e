"""The round engines of the port (the counterpart of ``mix_flat``,
``make_local_trainer``, ``DenseEngine`` and ``SampledEngine`` in
``repro.protocols.engine``).

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

``SampledEngine`` runs the same round body on a K-row active window of a
D-client ``ClientStateStore`` (``protocols.store``): the rows start from
each client's own stored state instead of the broadcast global model, and
the mixed rows are scattered back. Its ``run_rounds`` can pipeline rounds
on CUDA streams (see the class).

``MeshEngine`` trains the LM families' clients (``Model.loss_fn``) with
the federated state's client axis on one card, or over a mesh of ranks
through the protocols' ``psum_mix`` (see the class).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
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
from repro_torch.protocols import store as store_mod
from repro_torch.protocols.base import (
    Protocol, get_participation, validate_participation,
)
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
    """Every random draw of one round: ``sel`` [P] int64 participants (on
    the sampled engine: the K active ids over the D enrolled clients),
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
# The round body both engines share
# ---------------------------------------------------------------------------

class _RoundEngine:
    """What ``DenseEngine`` and ``SampledEngine`` share: the device, the
    data on it, the wire, a round's draws after the selection, evaluation
    and ONE round body (``_round_body``), which starts from [P, sum(sizes)]
    round-start rows — the broadcast global model on the dense engine, the
    clients' own stored rows on the sampled one."""

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

    def init_params(self, seed: int = 0):
        """The net's initial params from ``seed``, on the engine's device."""
        return init_paper_net(torch.Generator().manual_seed(seed), self.net,
                              device=self.device)

    # -- randomness --------------------------------------------------------
    def _draw_rest(self, gen: torch.Generator, sel, cids,
                   P: int) -> RoundDraws:
        """The draws after the selection, in this order: the straggler
        mask, the batch orders, the matchings and the int8 wire's noise."""
        fl = self.fl
        survive = straggler_mask(gen, P, fl.straggler_rate)
        n_max = self.data_dev["y"].shape[1]
        subs = max(1, fl.sync_period)
        u = torch.rand((subs, P, fl.local_epochs, n_max), generator=gen,
                       device=gen.device)
        R = self.proto.num_matchings(fl, P)
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

    # -- one round -----------------------------------------------------------
    def _round_body(self, spec, flat_old, data_ids, draws: RoundDraws,
                    round_index: int = 0, codec_state=None, fault=None, *,
                    num_clusters: int, active_ids=None,
                    num_enrolled: int = 0):
        """One protocol round from the [P, sum(sizes)] round-start rows
        ``flat_old`` (contiguous; ``spec`` its TreeSpec): local training on
        the clients' data rows ``data_ids`` [P], then the mix. Returns the
        mixed PER-CLIENT rows ``(flat_mixed [P, sum(sizes)], losses [P],
        codec_state)``; ``losses`` are the last sub-round's,
        ``codec_state`` the threaded error-feedback residual (None without
        a stateful codec). ``active_ids`` / ``num_enrolled`` reach the
        RoundContext (the sampled window's).

        ``fault`` (active plans only) is this round's ``(drop [P], flag
        [P], mode [P])`` on the engine's device: dropped clients leave the
        survive mask for every sub-round, flagged clients' FINAL uploads
        are poisoned (``corrupt_flat``), rows that are non-finite or
        flagged are taken out of the mix like stragglers and their bytes
        replaced with the round-start row (a masked NaN row would still
        poison a dense product through 0 · nan), and the scatter-back
        guard reverts any rejected row to its round-start value. The
        return then grows a 4th element: the rejected-row mask [P] bool."""
        fl, data = self.fl, self.data_dev
        cids, survive, perms = (t.to(self.device) for t in (
            draws.cluster_ids, draws.survive, draws.batch_perm))
        drop = flag = mode = None
        if fault is not None:
            drop, flag, mode = fault
            survive = survive * (1.0 - drop)
        # gathered ONCE per round: the selection is fixed across sub-rounds
        cx, cy, cm = data["x"][data_ids], data["y"][data_ids], \
            data["mask"][data_ids]
        counts = data["counts"][data_ids]
        matching, noise = (None if t is None else t.to(self.device)
                           for t in (draws.matching, draws.wire_noise))

        def mix(flat_new, r: int, sync: bool, cstate, mask=survive):
            """Mix r (1-based): its matching and rounding noise are entry
            r-1 of the round's draws."""
            ctx = make_context(
                round_index=round_index, survive=mask, counts=counts,
                cluster_ids=cids, num_clusters=num_clusters,
                do_global_sync=sync,
                matching=None if matching is None else matching[r - 1],
                topology=self.topology, fault_drop=drop,
                active_ids=active_ids, num_enrolled=num_enrolled)
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
        return guarded, losses, cstate, bad


# ---------------------------------------------------------------------------
# Dense engine
# ---------------------------------------------------------------------------

class DenseEngine(_RoundEngine):
    """Drives one protocol's rounds on the paper's own model classes
    (§4.2) on a PACKED federated state (see the module docstring).

    ``device=None`` means the card (and raises where there is none);
    ``device="cpu"`` runs the kernels' plain versions. ``codec`` is a
    ``repro_torch.compression`` name or Codec (``None``/``"none"`` runs
    the codec-free program). ``topology`` (a ``core.topology.Topology``)
    reaches the protocol's ``partition`` and every ``RoundContext``.
    ``faults`` is a ``repro_torch.faults.FaultPlan``; ``None`` or an empty
    plan runs the fault-free program."""

    # -- randomness --------------------------------------------------------
    def draw_round(self, gen: torch.Generator) -> RoundDraws:
        """One round's draws from ``gen`` (on the engine's device)."""
        P = self.proto.num_participants(self.fl)
        sel, cids = self.proto.partition(gen, self.fl, self.topology)
        return self._draw_rest(gen, sel, cids, P)

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
        model, ``spec`` its TreeSpec; every participant starts from it.
        Returns ``_round_body``'s ``(flat_mixed [P, sum(sizes)], losses
        [P], codec_state)``; with ``fault`` (see ``_round_body``) a 4th
        element, ``{'dropped', 'rejected_rows'}`` 0-d int32 counters."""
        P = self.proto.num_participants(self.fl)
        sel = draws.sel.to(self.device)
        # the round-start state of every participant (contiguous: the
        # kernels take dense [P, sum(sizes)] buffers)
        flat_old = flat_params[None].expand(P, -1).contiguous()
        out = self._round_body(spec, flat_old, sel, draws, round_index,
                               codec_state, fault,
                               num_clusters=self.proto.num_clusters(self.fl))
        if fault is None:
            return out
        guarded, losses, cstate, bad = out
        counters = {"dropped": fault[0].sum().to(torch.int32),
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
        _check_draws(draws, gen, T)
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


def _check_draws(draws, gen, T: int) -> None:
    if draws is None and gen is None:
        raise ValueError("run_rounds needs a generator or explicit draws")
    if draws is not None and len(draws) < T:
        raise ValueError(f"run_rounds: {len(draws)} RoundDraws for T={T} "
                         "rounds")


# ---------------------------------------------------------------------------
# Sampled engine — a persistent store and a per-round active window
# ---------------------------------------------------------------------------

FAULT_COUNTERS = ("dropped", "rejected_rows", "retries", "prefetch_fallbacks")


class SampledEngine(_RoundEngine):
    """Drives protocol rounds over a persistent ``ClientStateStore``
    (``protocols.store``): D clients are ENROLLED but only K are ACTIVE per
    round. Each round —

      1. select  — the participation strategy (``fl.participation_strategy``)
                   draws [K] active ids from the D-client population (the
                   only O(D) work of a round), with the rest of the round's
                   draws (``draw_round``);
      2. gather  — the store yields the active [K, sum(sizes)] rows (and
                   their codec residuals);
      3. window  — ``_round_body`` on [K, sum(sizes)] only: local SGD from
                   each client's OWN stored row (no broadcast, no consensus
                   collapse), then the mix over the window with the
                   protocol's static window layout (``mesh_cluster_ids``),
                   the RoundContext carrying ``active_ids`` and
                   ``num_enrolled``; nothing in it touches a generator;
      4. scatter — mixed rows (and residuals) write back; the store's
                   ``last_round`` staleness counters advance.

    With ``active_ids = arange(D)`` (K == P == D and a fresh store) a
    window round is bit for bit the ``DenseEngine`` round of the same
    draws. Client i's data is row ``active_ids[i] % data_clients``
    (enrollment may exceed the dataset's client count; the map is cyclic).

    ``pipeline_depth`` d >= 2 makes ``run_rounds`` a software pipeline of
    up to d windows in flight: round t+1's draws and store prefetch (stage
    A) and round t-1's scatter (stage C) overlap round t's window (stage
    B). On the card stage A's selection and copies run on a stream of
    their own, ordered by events, so reading round t+1's ids never waits
    for round t's window; the cold tier's window copies go through pinned
    buffers (its fetch thread copies on the store's stream; the mixed rows
    come back on a copy stream, started as the window is enqueued, and are
    written back on the fetch thread: on the card the host launches a
    window's kernels until shortly before it ends, so host work left on
    this thread would idle the card).
    Results equal the serial loop's bit for bit at every depth: id
    overlaps between in-flight rounds are found on the host id vectors
    and only the conflicting rows are patched from the in-flight outputs
    (``_acquire_window``).

    ``faults`` (a ``repro_torch.faults.FaultPlan``) routes rounds through
    the fault wire and the scatter-back guard, arms a ``FaultInjector`` on
    the store's read and prefetch hooks, and gives rejected clients a cold
    retry in a later round's tail slots. ``device=None`` means the card.
    """

    def __init__(self, net: PaperNetConfig, data_dev: Dict, fl: FLConfig,
                 proto: Protocol, topology: Optional[Topology] = None, *,
                 codec=None, mix_path: Optional[str] = None,
                 pipeline_depth: int = 1, faults=None,
                 prefetch_timeout: Optional[float] = None, device=None):
        super().__init__(net, data_dev, fl, proto, topology, codec=codec,
                         mix_path=mix_path, faults=faults, device=device)
        self._injector = (fault_lib.FaultInjector(self.faults)
                          if self.faults is not None else None)
        #: clients whose rows the guard rejected, awaiting their cold
        #: retry: spliced into the tail slots of the next selection
        self._retry_queue: list = []
        #: {round -> counter dict} accumulated by the host driver
        self._fault_log: Dict[int, Dict[str, int]] = {}
        #: seconds ``_prefetch_rows`` waits on a prefetch handle before
        #: falling back to a synchronous gather (None = wait forever,
        #: though a DEAD worker still raises at once and falls back);
        #: default ``fl.prefetch_timeout`` (0 = forever)
        pt = (fl.prefetch_timeout if prefetch_timeout is None
              else prefetch_timeout)
        self.prefetch_timeout = float(pt) if pt else None
        #: D — enrolled population; K — active window per round
        self.num_enrolled = fl.enrolled
        self.window = validate_participation(fl, proto)
        #: the static window cluster layout (the protocol's own at width K)
        cids = proto.mesh_cluster_ids(self.window, fl)
        self._num_clusters = int(cids.max()) + 1 if cids.size else 1
        self._cluster_ids = torch.from_numpy(cids).to(self.device)
        self._data_clients = int(self.data_dev["counts"].shape[0])
        self._strategy = get_participation(fl.participation_strategy)
        self.pipeline_depth = self._check_depth(pipeline_depth)
        #: stage A's stream and the card->host copy stream (card only)
        self._streams = None
        self.store = None
        self._spec = None

    @staticmethod
    def _check_depth(depth) -> int:
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {depth}")
        return depth

    @property
    def _codec_stateful(self) -> bool:
        return self.codec is not None and self.codec.stateful

    # -- randomness --------------------------------------------------------
    def draw_round(self, gen: torch.Generator) -> RoundDraws:
        """One round's draws from ``gen``: the K active ids over D, the
        static window layout, then the same draws as ``DenseEngine``'s in
        the same order — so at K == P == D with uniform selection one
        generator state gives both engines the same round."""
        K = self.window
        sel = self._strategy.select(gen, self.num_enrolled, K, self.fl)
        return self._draw_rest(gen, sel, self._cluster_ids, K)

    # -- store lifecycle -----------------------------------------------------
    def init_store(self, params, *, tier: str = "auto", store=None):
        """Enroll D clients, every one starting at ``params``: packs the
        global model once and builds (or adopts) the store, on the
        engine's device. The TreeSpec captured here is the packed layout
        of every later window."""
        row, spec = self._pack_params(params)
        self._spec = spec
        if store is not None:
            if store.width != row.shape[-1]:
                raise ValueError(
                    f"store width {store.width} does not match the packed "
                    f"model width {row.shape[-1]}")
            self.store = store
        else:
            self.store = store_mod.make_store(
                row.to(self.device), self.num_enrolled, tier=tier,
                residual=self._codec_stateful,
                read_retries=self.fl.store_read_retries,
                read_backoff=self.fl.store_read_backoff)
        if self._injector is not None:
            # the store's read/prefetch hooks fire this engine's plan
            self.store.fault_injector = self._injector
        return self.store

    # -- the window round ------------------------------------------------------
    def _window(self, flat_win, draws: RoundDraws, round_index: int = 0,
                codec_state=None, fault=None):
        """One round on the [K, sum(sizes)] active window ``flat_win`` (the
        clients' stored rows: training starts from them and stragglers
        fall back to them). Returns ``(flat_mixed, mean_loss,
        codec_state)``; with ``fault`` the rejected-row mask [K] follows,
        and a rejected row's residual is reverted with the row."""
        ids = draws.sel.to(self.device)
        out = self._round_body(
            self._spec, flat_win, ids % self._data_clients, draws,
            round_index, codec_state, fault, num_clusters=self._num_clusters,
            active_ids=ids, num_enrolled=self.num_enrolled)
        flat_mixed, losses, cstate = out[:3]
        if not self._codec_stateful:
            cstate = None
        if fault is None:
            return flat_mixed, losses.mean(), cstate
        bad = out[3]
        if cstate is not None:
            cstate = torch.where(bad[:, None], codec_state, cstate)
        return flat_mixed, losses.mean(), cstate, bad

    # -- fault-mode host bookkeeping -------------------------------------------
    def _log_fault(self, t: int, **kw) -> None:
        rec = self._fault_log.setdefault(
            int(t), {name: 0 for name in FAULT_COUNTERS})
        for k, v in kw.items():
            rec[k] += int(v)

    def _splice_retries(self, ids_np: np.ndarray) -> np.ndarray:
        """Cold retry: clients the guard rejected earlier replace the TAIL
        slots of this selection (skipping ids already selected — being
        picked again IS the retry). Returns the patched id vector."""
        if not self._retry_queue:
            return ids_np
        ids_np = np.array(ids_np, copy=True)
        present = {int(c) for c in ids_np}
        take, rest = [], []
        for c in self._retry_queue:
            if int(c) in present:
                continue                     # selected organically — retried
            if len(take) < ids_np.shape[0]:
                take.append(int(c))
                present.add(int(c))
            else:
                rest.append(int(c))
        self._retry_queue = rest
        if take:
            ids_np[-len(take):] = np.asarray(take, ids_np.dtype)
        return ids_np

    def _fault_vectors(self, spec, ids_np: np.ndarray):
        """This round's per-slot ``(drop, flag, mode)`` host vectors: the
        ``FaultSpec`` names ENROLLED client ids; ids not in this window do
        not fire."""
        K = ids_np.shape[0]
        drop = np.zeros((K,), np.float32)
        flag = np.zeros((K,), np.float32)
        mode = np.zeros((K,), np.int32)
        if spec is not None:
            pos = {int(c): j for j, c in enumerate(ids_np)}
            for c in spec.drop:
                j = pos.get(int(c))
                if j is not None:
                    drop[j] = 1.0
            for c, m in spec.corrupt:
                j = pos.get(int(c))
                if j is not None:
                    flag[j] = 1.0
                    mode[j] = fault_lib.MODE_CODES[m]
        return drop, flag, mode

    def _requeue_rejected(self, ids_np: np.ndarray, bad_np: np.ndarray,
                          drop: np.ndarray, t: int) -> np.ndarray:
        """Post-guard host bookkeeping of both drivers: requeue rejected
        clients for their cold retry, log the round's counters, and return
        the ids whose staleness may advance (accepted and not dropped)."""
        for c in ids_np[bad_np]:
            if int(c) not in self._retry_queue:
                self._retry_queue.append(int(c))
        self._log_fault(t, dropped=int(drop.sum()),
                        rejected_rows=int(bad_np.sum()))
        return ids_np[(~bad_np) & (drop == 0)]

    def _arm_faults(self, draws: RoundDraws, ids_np: np.ndarray, t: int):
        """Fault mode's per-round set-up, before any store read of round
        t: arm the injector, splice cold retries into the selection
        (``ids_np``, the drawn ids on the host). Returns (the draws with
        the spliced ids, their host vector, the host fault vectors, their
        device copies)."""
        self._injector.begin_round(t)
        ids_np = self._splice_retries(ids_np)
        draws = dataclasses.replace(
            draws, sel=kernel_ops.host_to_device(ids_np, self.device))
        vecs = self._fault_vectors(self.faults.for_round(t), ids_np)
        dev = tuple(kernel_ops.host_to_device(v, self.device) for v in vecs)
        return draws, ids_np, vecs, dev

    # -- the serial driver ---------------------------------------------------
    def round(self, gen: Optional[torch.Generator] = None,
              round_index: int = 0, *, draws: Optional[RoundDraws] = None):
        """One sampled round against the store: draw -> gather -> window ->
        scatter/touch. The round's draws are ``draws`` when given, else
        drawn from ``gen``. Returns the round's mean train loss (a 0-d
        tensor on the engine's device)."""
        if self.store is None:
            raise ValueError("SampledEngine.round: call init_store(params) "
                             "first — the engine has no enrolled state")
        d = draws if draws is not None else self.draw_round(gen)
        if self.faults is not None:
            return self._round_faulted(d, round_index)
        ids_np = _host_ids(d.sel)
        flat_win = self.store.gather(ids_np)
        res = (self.store.gather_residual(ids_np) if self._codec_stateful
               else None)
        flat_mixed, loss, res = self._window(flat_win, d, round_index, res)
        if res is not None:
            self.store.scatter_residual(ids_np, res)
        self.store.scatter(ids_np, flat_mixed)
        self.store.touch(ids_np, round_index)
        return loss

    def _round_faulted(self, d: RoundDraws, t: int):
        """The serial round under an active plan: arm the injector, splice
        cold retries into the selection, run the fault-wired window, then
        scatter the GUARDED rows (a rejected row writes back its pre-round
        bytes) and touch only the accepted ids. Store read retries are
        metered per round by the cumulative counter's delta."""
        d, ids_np, (drop, _, _), fault = self._arm_faults(
            d, _host_ids(d.sel), t)
        r0 = self.store.read_retry_count
        flat_win = self.store.gather(ids_np)
        res = (self.store.gather_residual(ids_np) if self._codec_stateful
               else None)
        flat_out, loss, res, bad = self._window(flat_win, d, t, res, fault)
        bad_np = bad.cpu().numpy()
        if res is not None:
            self.store.scatter_residual(ids_np, res)
        self.store.scatter(ids_np, flat_out)
        self.store.touch(self._requeue_rejected(ids_np, bad_np, drop, t), t)
        self._log_fault(t, retries=self.store.read_retry_count - r0)
        return loss

    # -- the software pipeline (pipeline_depth >= 2) ---------------------------
    def _side_streams(self):
        """(stage A's stream, the card->host copy stream) on the card,
        (None, None) on the CPU."""
        if self.device.type != "cuda":
            return None, None
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        return self._streams

    def _issue_round(self, gen, draws, t: int, writes):
        """Stage A: draw round t and start the store prefetch (``writes``:
        the write-backs submitted so far, which the prefetch follows). The
        draws
        depend only on the generator — never on store contents — so they
        can run ahead of the scatters. On the card they run on stage A's
        stream and the ids come back to the host from there: this waits
        for the selection only, not for the window running on the main
        stream, which then waits on stage A's event before it reads any
        draw (each draw tensor is marked as used on the main stream)."""
        stream_a, _ = self._side_streams()
        with store_mod.stream_ctx(stream_a):
            d = draws[t] if draws is not None else self.draw_round(gen)
            ids = (store_mod.HostCopy(d.sel)
                   if stream_a is not None and d.sel.is_cuda else None)
        ids_np = ids.numpy().copy() if ids is not None else _host_ids(d.sel)
        if stream_a is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(stream_a)
            for f in dataclasses.fields(d):
                x = getattr(d, f.name)
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(main)
        cur = {"t": t, "draws": d, "ids_np": ids_np}
        if self.faults is not None:
            # the injector is armed BEFORE the prefetch goes out: round
            # t's store reads are the ones its spec targets
            d, ids_np, vecs, fault = self._arm_faults(d, ids_np, t)
            cur.update(draws=d, ids_np=ids_np, fault=vecs, fault_dev=fault,
                       r0=self.store.read_retry_count)
        # the prefetch goes on the main stream (after every scatter
        # enqueued so far) or, on the cold tier, to the fetch thread
        cur["writes_before"] = list(writes)
        cur["win"] = self.store.prefetch(ids_np)
        cur["res"] = (self.store.prefetch_residual(ids_np)
                      if self._codec_stateful else None)
        return cur

    def _patch_rows(self, win, ids_np, sources, field):
        """Overwrite rows of ``win`` whose ids collide with in-flight
        rounds: ``sources`` are older rounds (in round order) whose
        scatters the prefetch behind ``win`` may not have seen — their
        outputs are the rows a serial gather WOULD have returned. Oldest
        first, so the newest writer of an id wins, as in serial scatter
        order. The cast mirrors the store's scatter-side cast."""
        for p in sources:
            src = p[field]
            if src is None:
                continue
            pos = {int(c): j for j, c in enumerate(p["ids_np"])}
            hit_i = [i for i, c in enumerate(ids_np) if int(c) in pos]
            if not hit_i:
                continue
            hit_j = [pos[int(ids_np[i])] for i in hit_i]
            win.index_copy_(
                0, kernel_ops.host_to_device(np.array(hit_i, np.int64),
                                             win.device),
                src.index_select(0, kernel_ops.host_to_device(
                    np.array(hit_j, np.int64), src.device)).to(win.dtype))
        return win

    def _acquire_window(self, cur, shadow, pending):
        """Finish stage A for round ``cur``: collect the prefetch, then make
        the window serially consistent. Two kinds of rounds may own rows
        the prefetch missed: ``pending`` rounds (enqueued, not yet
        scattered) and ``shadow`` rounds (scattered AFTER this prefetch
        was issued — the fetch thread may have read pre-scatter rows).
        Both patch from their in-flight outputs; patching a row the
        prefetch DID see post-scatter rewrites it with the same bits."""
        ids_np = cur["ids_np"]
        sources = shadow + pending
        flat_win = self._patch_rows(
            self._prefetch_rows(cur, "win", self.store.gather), ids_np,
            sources, "out_flat")
        res = None
        if self._codec_stateful:
            res = self._patch_rows(
                self._prefetch_rows(cur, "res", self.store.gather_residual),
                ids_np, sources, "out_res")
        return flat_win, res

    def _prefetch_rows(self, cur, field, sync_gather):
        """Collect one prefetch handle with the engine's timeout. A DEAD
        worker (its exception re-raises here) or a STUCK one (timeout) is
        not fatal: the round falls back to a synchronous gather, counted
        in ``prefetch_fallbacks``, once the write-backs submitted before
        the prefetch have landed (rounds retired later are patched). A
        permanent store failure (e.g. ``CheckpointCorruptionError``) then
        raises from the synchronous path, so real errors still surface."""
        try:
            return cur[field].result(self.prefetch_timeout)
        except Exception:   # any worker failure: the synchronous path decides
            if self.faults is not None:
                self._log_fault(cur["t"], prefetch_fallbacks=1)
            for w in cur["writes_before"]:
                w.result()
            return sync_gather(cur["ids_np"])

    def _retire_round(self, p, writes):
        """Stage C: write round p's mixed rows (+ residual) back and
        advance staleness. On the cold tier the rows' copy to the host was
        started when the window was enqueued (``host_flat``) and the
        write-back runs on the store's fetch thread: this thread goes on
        to launch the next window (on the card the host stays busy
        launching a window's kernels until shortly before it ends, so host
        work left on this thread would leave the card idle). Its handle
        joins ``writes``."""
        res = p["out_res"]
        writes.append(self.store.write_back(
            p["ids_np"], p.get("host_flat", p["out_flat"]),
            None if res is None else p.get("host_res", res)))
        # fault mode touches only the accepted ids (the guard already
        # reverted rejected rows, so the write-back is safe)
        touch = p.get("touch_ids")
        self.store.touch(p["ids_np"] if touch is None else touch, p["t"])

    def _run_rounds_pipelined(self, gen, T: int, depth: int, draws):
        """T rounds with up to ``depth`` windows in flight. Per iteration:
        acquire round t's prefetched window (patching id conflicts),
        enqueue its window (stage B), issue round t+1's draws and prefetch
        (stage A), then retire the oldest rounds (stage C) until at most
        depth-1 stay in flight. Retires run in round order, so
        ``last_round`` and the store match serial exactly."""
        _, copy_stream = self._side_streams()
        host_copies = (self.store.resident_flat() is None
                       and copy_stream is not None)
        pending, shadow, writes, losses = [], [], [], [None] * T
        nxt = self._issue_round(gen, draws, 0, writes) if T > 0 else None
        for t in range(T):
            cur = nxt
            flat_win, res = self._acquire_window(cur, shadow, pending)
            # every prefetch issued from here on sees the shadow rounds'
            # scatters (they were enqueued or done before it) — drop them
            shadow.clear()
            out = self._window(flat_win, cur["draws"], t, res,
                               cur.get("fault_dev"))
            out_flat, loss, out_res = out[:3]
            cur.update(out_flat=out_flat, out_res=out_res)
            if host_copies:
                # start the card->host copies now, so stage C finds the
                # bytes waiting
                cur["host_flat"] = store_mod.HostCopy(out_flat, copy_stream)
                if out_res is not None:
                    cur["host_res"] = store_mod.HostCopy(out_res,
                                                         copy_stream)
            losses[t] = loss
            pending.append(cur)
            if self.faults is not None:
                # read the guard's verdict BEFORE issuing round t+1, so the
                # retry splice sees this round's rejections at every depth
                # — fault mode trades that slice of overlap for
                # depth-invariant cold-retry semantics
                bad_np = out[3].cpu().numpy()
                cur["touch_ids"] = self._requeue_rejected(
                    cur["ids_np"], bad_np, cur["fault"][0], t)
                self._log_fault(
                    t, retries=self.store.read_retry_count - cur["r0"])
            nxt = (self._issue_round(gen, draws, t + 1, writes)
                   if t + 1 < T else None)
            while len(pending) > depth - 1:
                p = pending.pop(0)
                self._retire_round(p, writes)
                shadow.append(p)
        for p in pending:
            self._retire_round(p, writes)
        for w in writes:          # the store is whole when the run returns
            w.result()
        return losses

    def run_rounds(self, gen: Optional[torch.Generator], T: int, *,
                   draws: Optional[Sequence[RoundDraws]] = None,
                   pipeline_depth: Optional[int] = None):
        """Run T sampled rounds against the store (a host loop: the store
        is host-owned state). Round t's draws are ``draws[t]`` when given,
        else drawn from ``gen`` in round order at every depth.
        ``pipeline_depth`` (default: the engine's) overlaps draw/prefetch
        and scatter with the window at depth >= 2, bit for bit the depth-1
        serial loop. Returns metrics with ``train_loss``, the [T] per-round
        mean losses (numpy f32); under an active fault plan also the four
        per-round counters ``dropped``, ``rejected_rows``, ``retries`` and
        ``prefetch_fallbacks`` ([T] int64)."""
        if self.store is None:
            raise ValueError("SampledEngine.run_rounds: call "
                             "init_store(params) first")
        depth = self._check_depth(self.pipeline_depth if pipeline_depth
                                  is None else pipeline_depth)
        T = int(T)
        _check_draws(draws, gen, T)
        if self.faults is not None:
            # one run_rounds call == one chaos run: counters and the
            # cold-retry queue start clean
            self._fault_log = {}
            self._retry_queue = []
        if depth == 1:
            losses = [self.round(gen, t,
                                 draws=None if draws is None else draws[t])
                      for t in range(T)]
        else:
            losses = self._run_rounds_pipelined(gen, T, depth, draws)
        metrics = {"train_loss": (torch.stack(losses).cpu().numpy() if T
                                  else np.zeros((0,), np.float32))}
        if self.faults is not None:
            for name in FAULT_COUNTERS:
                metrics[name] = np.asarray(
                    [self._fault_log.get(t, {}).get(name, 0)
                     for t in range(T)], np.int64)
        return metrics

    def global_params(self):
        """Consensus readout: the mean over ALL enrolled rows, unpacked to
        the model's params. On the resident tier this is ``mean_packed``
        over the live buffer (each leaf in its own dtype, as the dense
        engine collapses); other tiers go through the store's
        ``consensus()``."""
        if self.store is None:
            raise ValueError("SampledEngine.global_params: no store")
        flat = self.store.resident_flat()
        if flat is not None:
            row = kernel_ops.mean_packed(flat, self._spec)
        else:
            row = torch.from_numpy(self.store.consensus()).to(self.device)
        return kernel_ops.unpack_tree(row, self._spec)


# ---------------------------------------------------------------------------
# Mesh engine — federated LM training, one card or a mesh of ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshDraws:
    """Every random draw of one ``MeshEngine`` round, the same on every
    rank: ``survive`` [D] f32 straggler mask, ``matching`` the 0-d int64
    matching index of a protocol that draws one (gossip_async) or None,
    and ``wire_noise`` the int8 codec's rounding noise — on the one-card
    path one [D, n_pad] buffer over the packed width (n_pad: sum(sizes)
    rounded up to the codec's chunk), on the mesh path a tuple of [D,
    n_pad_leaf] buffers, one a leaf (the JAX package's per-leaf
    ``fold_in``); None rounds to nearest. The engine moves them to its
    device and takes its own rows of the noise."""
    survive: torch.Tensor
    matching: Optional[torch.Tensor] = None
    wire_noise: object = None


class MeshEngine:
    """Drives one protocol's rounds of federated LM training (the
    counterpart of ``repro.protocols.engine.MeshEngine``): every parameter
    leaf carries a leading client axis [D, ...]; local training is E =
    ``local_steps`` SGD steps a client, ``(w - lr * g.f32).to(w.dtype)``,
    a loop over the clients (the JAX package's client-diagonal ``vmap``:
    the kernels' autograd Functions have no vmap rule); mixing is:

    * with ``mesh_info`` (a ``sharding.rules.MeshInfo``), the protocol's
      ``psum_mix`` — one client a rank, ``f_params`` and ``batches`` this
      rank's rows ([1, ...]; ``core.fedp2p.federated_rows``), the
      collectives over process groups made here, at construction, in the
      same order on every rank;
    * without, all D clients on this device: the protocol's
      ``mixing_spec`` kernels, or on ``mix_path="dense"`` (or a spec-less
      protocol) the dense ``fed_mix``; int8 on the dense path is
      ``fed_mix_q``.

    The state is kept as ONE packed [D, sum(sizes)] buffer whose leaves
    are views (``kernels.ops.packed_view``; ``core.fedp2p
    .broadcast_to_clients`` makes it so): a round packs nothing, trains
    into a second buffer and mixes into a third.

    ``counts`` are the non-uniform per-client weights |D_i| (default
    uniform). ``codec`` (default ``fl.codec``) is the lossy wire: on the
    mesh it rides ``RoundContext.codec`` into ``psum_mix``, per leaf; one
    card quantizes the packed buffer. A stateful codec's residual is
    returned as a third element and threaded by ``run_rounds``.

    ``round_fn(f_params, batches, draws, do_global_sync=True,
    round_index=0, codec_state=None) -> (f_params', mean_loss)``: batch
    leaves [D, local_steps, ...], ``draws`` a ``MeshDraws``.
    ``run_rounds(f_params, gen, T, batches)`` runs T rounds (batch leaves
    [T, D, local_steps, ...]); the global sync fires when (t+1) %
    sync_period == 0, as in the paper, and never in the T % sync_period
    tail rounds. ``device=None`` means the card."""

    def __init__(self, model, fl: FLConfig, num_clients_dev: int,
                 local_steps: int, *, algorithm: str = "", counts=None,
                 remat: bool = True, mesh_info=None, codec=None,
                 mix_path: Optional[str] = None, device=None):
        from repro_torch.launch.steps import _loss_and_grad
        from repro_torch.protocols.base import get
        self.proto = get(algorithm or fl.algorithm)
        self.fl = fl
        self.num_clients_dev = D = int(num_clients_dev)
        self.local_steps = int(local_steps)
        self.mesh_info = mesh_info
        self.device = backend.resolve_device(device)
        self.mix_path = _check_mix_path(mix_path or fl.mix_path)
        self.codec = compression.active(codec if codec is not None
                                        else fl.codec)
        ids = self.proto.mesh_cluster_ids(D, fl)
        self._cluster_ids = ids
        self._num_clusters = int(ids.max()) + 1
        self._ids_dev = torch.from_numpy(ids).to(self.device)
        self._counts = (torch.ones((D,), dtype=torch.float32,
                                   device=self.device) if counts is None
                        else torch.as_tensor(counts, dtype=torch.float32)
                        .to(self.device))
        if mesh_info is not None:
            if mesh_info.axis_sizes and mesh_info.tp_size > 1:
                raise NotImplementedError(
                    "MeshEngine: a client on a model axis of "
                    f"{mesh_info.tp_size} ranks (and more than one client a "
                    "rank) is ROADMAP item 13b.2; the federated mesh is "
                    "(data=D, model=1)")
            if mesh_info.world_size != D:
                raise ValueError(
                    f"MeshEngine: the mesh holds one client a rank; got "
                    f"{D} clients on {mesh_info.world_size} ranks")
            mesh_info.build_groups(self.proto.mesh_partitions(D, ids))
        self._loss_and_grad = _loss_and_grad(model, remat)
        #: (f_params, batches, draws[, do_global_sync, round_index,
        #: codec_state]) -> (f_params', mean_loss[, codec_state])
        self.round_fn = self._round

    @property
    def _codec_stateful(self) -> bool:
        return self.codec is not None and self.codec.stateful

    # -- randomness --------------------------------------------------------
    def draw_round(self, gen: torch.Generator, f_params) -> MeshDraws:
        """One round's draws from ``gen``, in this order: the straggler
        mask, the matching index, the int8 wire's noise (its widths from
        ``f_params``' leaves). Every rank that draws from a generator of
        the same seed and device gets the same record."""
        D, fl = self.num_clients_dev, self.fl
        survive = straggler_mask(gen, D, fl.straggler_rate)
        R = self.proto.num_matchings(fl, D)
        matching = (torch.randint(0, R, (), generator=gen, device=gen.device)
                    if R else None)
        noise = None
        if isinstance(self.codec, compression.Int8Codec):
            sizes = [leaf[0].numel()
                     for leaf in kernel_ops.tree_flatten(f_params)[0]]
            widths = ([self.codec.padded(n) for n in sizes]
                      if self.mesh_info is not None
                      else [self.codec.padded(sum(sizes))])
            noise = tuple(torch.rand((D, w), generator=gen,
                                     device=gen.device) for w in widths)
            if self.mesh_info is None:
                noise = noise[0]
        return MeshDraws(survive=survive, matching=matching,
                         wire_noise=noise)

    # -- local training ------------------------------------------------------
    def _local_train(self, flat_params, spec, batches):
        """E SGD steps for every client row of ``flat_params`` [n,
        sum(sizes)] (its leaves read as views, not modified), written into
        a new [n, sum(sizes)] buffer. -> (flat_new, losses [n]): each
        client's loss averaged over its steps."""
        lr = self.fl.lr
        flat_new = torch.empty_like(flat_params)
        losses = []
        for i in range(flat_params.shape[0]):
            leaves, treedef = kernel_ops.tree_flatten(
                kernel_ops.unpack_tree(flat_params[i], spec))
            step_losses = []
            for st in range(self.local_steps):
                batch = {k: v[i, st].to(self.device, non_blocking=True)
                         for k, v in batches.items()}
                loss, _, grads = self._loss_and_grad(
                    kernel_ops.tree_unflatten(treedef, leaves), batch)
                grads = kernel_ops.tree_flatten(grads)[0]
                leaves = [(w - lr * g.to(torch.float32)).to(w.dtype)
                          for w, g in zip(leaves, grads)]
                del grads
                step_losses.append(loss)
            off = 0
            for leaf, size in zip(leaves, spec.sizes):
                flat_new[i, off:off + size].copy_(leaf.reshape(-1))
                off += size
            losses.append(torch.stack(step_losses).mean())
        return flat_new, torch.stack(losses)

    # -- one round -----------------------------------------------------------
    def _ctx(self, draws: MeshDraws, round_index: int, sync: bool):
        noise = draws.wire_noise
        if noise is not None and self.mesh_info is not None:
            rows = list(self.mesh_info.clients)    # this rank's rows
            noise = [u[rows].to(self.device) for u in noise]
        return make_context(
            round_index=round_index,
            survive=draws.survive.to(self.device, torch.float32),
            counts=self._counts,
            cluster_ids=(self._ids_dev if self.mesh_info is None
                         else torch.from_numpy(self._cluster_ids)),
            num_clusters=self._num_clusters, do_global_sync=sync,
            matching=draws.matching, mesh_info=self.mesh_info,
            codec=self.codec, wire_noise=noise)

    def _round(self, f_params, batches, draws: MeshDraws,
               do_global_sync: bool = True, round_index: int = 0,
               codec_state=None):
        flat_old, spec = (kernel_ops.packed_view(f_params)
                          or kernel_ops.pack_tree(f_params))
        flat_new, losses = self._local_train(flat_old, spec, batches)
        out = self.mix(flat_new, flat_old, spec, draws, do_global_sync,
                       round_index, codec_state)
        if self.mesh_info is None:
            loss = losses.mean()
        else:
            loss = self.mesh_info.psum(losses.sum().reshape(1))[0] / \
                self.num_clients_dev
        return (out[0], loss) + out[1:]

    def mix(self, flat_new, flat_old, spec, draws: MeshDraws,
            do_global_sync: bool = True, round_index: int = 0,
            codec_state=None):
        """The round's mixing alone, on the packed rows this engine holds
        (``flat_new`` / ``flat_old`` [n, sum(sizes)], ``spec`` their
        TreeSpec) -> ``(f_out,)`` (views of one new packed buffer), or
        ``(f_out, codec_state)`` with a stateful codec."""
        ctx = self._ctx(draws, round_index, bool(do_global_sync))
        stateful = self._codec_stateful
        if self.mesh_info is not None:
            f_new = kernel_ops.unpack_tree(flat_new, spec)
            f_old = kernel_ops.unpack_tree(flat_old, spec)
            if stateful:
                if codec_state is None:
                    codec_state = compression.init_feedback_state(
                        self.codec, f_new)
                f_new, codec_state = compression.feedback_wire_tree(
                    self.codec, f_new, f_old, codec_state, u=ctx.wire_noise)
                ctx = ctx.replace(codec=None)
            f_out = self.proto.psum_mix(f_new, f_old, ctx)
            return (f_out, codec_state) if stateful else (f_out,)
        noise = (None if draws.wire_noise is None
                 else draws.wire_noise.to(self.device))
        flat_out, codec_state = mix_flat(
            self.proto, flat_new, flat_old, ctx, codec_state,
            mix_path=self.mix_path, codec=self.codec, u=noise)
        f_out = kernel_ops.unpack_tree(flat_out, spec)
        return (f_out, codec_state) if stateful else (f_out,)

    # -- the training loop ---------------------------------------------------
    def init_codec_state(self, f_params):
        """The zero error-feedback residual of a stateful codec (None
        otherwise): per leaf [n, size] f32 on the mesh, one packed [D,
        sum(sizes)] buffer on one card."""
        if not self._codec_stateful:
            return None
        if self.mesh_info is not None:
            return compression.init_feedback_state(self.codec, f_params)
        leaves = kernel_ops.tree_flatten(f_params)[0]
        total = sum(leaf[0].numel() for leaf in leaves)
        return torch.zeros((leaves[0].shape[0], total), dtype=torch.float32,
                           device=leaves[0].device)

    def run_rounds(self, f_params, gen: Optional[torch.Generator], T: int,
                   batches, codec_state=None, *,
                   draws: Optional[Sequence[MeshDraws]] = None):
        """Run T rounds. ``batches`` leaves are [T, n, local_steps, ...];
        round t's draws are ``draws[t]`` when given, else drawn from
        ``gen``. Returns ``(f_params, losses [T])``, the losses on the
        device (nothing read back), and with a stateful codec the final
        residual as a third element; ``codec_state`` seeds it (zeros when
        None). Callers that stage T in chunks (several calls) must thread
        it through, or each chunk boundary drops the feedback mass.

        The caller's ``f_params`` stays alive through the call, so from
        the second round on four [D, sum(sizes)] buffers are held (it, the
        current state, the trained rows, the mixed rows); where only three
        fit, drive ``round_fn`` round by round and keep no other
        reference to the state."""
        T = int(T)
        got = kernel_ops.tree_flatten(batches)[0][0].shape[0]
        if got != T:
            raise ValueError(f"batches carry {got} rounds, expected T={T}")
        _check_draws(draws, gen, T)
        stateful = self._codec_stateful
        cstate = codec_state
        if stateful and cstate is None:
            cstate = self.init_codec_state(f_params)
        sp = max(1, self.fl.sync_period)
        losses = []
        for t in range(T):
            d = draws[t] if draws is not None else self.draw_round(
                gen, f_params)
            # the T % sp tail rounds never reach (t+1) % sp == 0: no sync
            out = self._round(f_params, {k: v[t] for k, v in batches.items()},
                              d, (t + 1) % sp == 0, t, cstate)
            f_params, loss = out[:2]
            if stateful:
                cstate = out[2]
            losses.append(loss)
        losses = torch.stack(losses)
        return (f_params, losses, cstate) if stateful else (f_params, losses)


def _host_ids(sel) -> np.ndarray:
    """The active ids as a host int64 vector."""
    if isinstance(sel, torch.Tensor):
        return sel.detach().cpu().numpy().astype(np.int64, copy=False)
    return np.asarray(sel, np.int64)
