"""Analytic communication-cost model (paper §3.2, Fig. 3) — the port's
numpy-only copy of ``repro.core.comm_model`` (the protocols' ``comm_time``).

  H_avg  = (1 + alpha) M P / B_s
  H_p2p  = (1 + alpha) L M / B_s  +  P M / (L B_d)  +  2 M / B_d
  L*     = A sqrt(P),  A = sqrt(B_s / ((1 + alpha) B_d))
  min H_p2p = H_p2p at clamp(L*, [1, P])
  R      = H_avg / min H_p2p

where M = wire bytes, P = sampled devices/round, B_s = server uplink
bandwidth, B_d = device-device bandwidth, alpha = server down/up asymmetry,
gamma = B_s / B_d. H_p2p is convex in L, so the constrained optimum sits at
the clamped boundary when L* falls outside [1, P]. ``bits_per_param``
(default 32, full precision) scales the model to its wire bytes;
``CommParams.with_codec`` re-prices it for a ``repro_torch.compression``
codec.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CommParams:
    model_bytes: float            # M at full precision (32-bit params)
    server_bw: float              # B_s  (bytes/s)
    device_bw: float              # B_d  (bytes/s)
    alpha: float = 1.0            # downlink/uplink asymmetry (>= 1)
    bits_per_param: float = 32.0  # codec-adjusted wire width (32 = none)

    @property
    def gamma(self) -> float:
        return self.server_bw / self.device_bw

    @property
    def wire_bytes(self) -> float:
        """Bytes one model actually puts on the link under the codec."""
        return self.model_bytes * self.bits_per_param / 32.0

    def with_codec(self, codec) -> "CommParams":
        """Re-price for a ``repro_torch.compression`` codec (name or Codec):
        every H(·) then reports codec-adjusted bytes."""
        from repro_torch.compression import as_codec
        return dataclasses.replace(
            self, bits_per_param=as_codec(codec).bits_per_param())


def h_fedavg(p: CommParams, P: int) -> float:
    """Communication time of one FedAvg round with P sampled devices."""
    return (1.0 + p.alpha) * p.wire_bytes * P / p.server_bw


def h_fedp2p(p: CommParams, P: int, L: float) -> float:
    """Communication time of one FedP2P round with L local P2P networks."""
    return ((1.0 + p.alpha) * L * p.wire_bytes / p.server_bw
            + P * p.wire_bytes / (L * p.device_bw)
            + 2.0 * p.wire_bytes / p.device_bw)


def optimal_L(p: CommParams, P: int) -> float:
    """L* = A sqrt(P), A = sqrt(B_s / ((1+alpha) B_d)) — the UNCONSTRAINED
    continuous optimum; may fall outside the physical range [1, P]."""
    A = math.sqrt(p.server_bw / ((1.0 + p.alpha) * p.device_bw))
    return A * math.sqrt(P)


def clamped_optimal_L(p: CommParams, P: int) -> float:
    """L* clamped to the physical cluster-count range [1, P] (H_p2p is
    convex in L, so this is the constrained optimum)."""
    return min(max(optimal_L(p, P), 1.0), float(P))


def min_h_fedp2p(p: CommParams, P: int) -> float:
    """min_{L in [1, P]} H_p2p — the closed form (2M/B_d)(P/L* + 1) exactly
    when L* is interior, the boundary value otherwise."""
    return h_fedp2p(p, P, clamped_optimal_L(p, P))


def speedup_R(p: CommParams, P: int) -> float:
    """Eq. (2): R = H_avg / min H_p2p, with the physically-clamped L —
    the closed form (1+a)P / (2 sqrt(gamma (1+a) P) + 2 gamma) whenever
    L* is interior."""
    return h_fedavg(p, P) / min_h_fedp2p(p, P)


def allreduce_time(wire_bytes: float, n: int, bw: float) -> float:
    """Ring allreduce: 2 (n-1)/n * M / bw (paper §3.2 footnote)."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * wire_bytes / bw


def ring_wire_bytes(wire_bytes: float, n: int) -> float:
    """TOTAL bytes a ring allreduce of one ``wire_bytes`` payload puts on
    the links of its n-device group: 2 (n-1) M — the byte content of
    ``allreduce_time`` (n devices each move 2 (n-1)/n * M, so
    ``allreduce_time == ring_wire_bytes / (n * bw)``). This is the ONE
    convention shared by the static wire pass (``analysis.contracts``)
    and each protocol's declared ``wire_model``, so the
    ``wire-model-parity`` rule compares like with like."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) * wire_bytes
