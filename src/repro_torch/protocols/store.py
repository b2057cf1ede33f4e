"""ClientStateStore — the persistent [D, sum(sizes)] client state behind
sampled participation (the counterpart of ``repro.protocols.store``).

The resident ``DenseEngine`` keeps every participant of a round as a row
of one buffer. Sampled participation enrolls D clients but trains only K
<< D a round: client state lives in a store, each round the
``SampledEngine`` gathers a K-row *active window*, runs the round on
[K, sum(sizes)] only, and scatters the mixed rows back. Enrollment D then
prices storage, not compute.

Tiers (``make_store`` picks by footprint):

* ``MemoryStore``     — one packed [D, sum(sizes)] buffer on the engine's
                        device; gather is ``index_select``, scatter an
                        in-place ``index_copy_`` (``kernels.ops``
                        ``gather_rows_dev`` / ``scatter_rows_dev``): never a
                        copy of the whole state.
* ``CheckpointStore`` — the cold tier for D where [D, sum(sizes)] cannot
                        exist (D = 10^6 clients of CNN-FEMNIST would be
                        986 GB): untouched clients hold one shared base
                        row (or a row of an npz checkpoint, read with
                        ``checkpoint.io.load_leaves`` partial-row reads),
                        and only rows a round touched live in a host
                        overlay. Host memory scales with rounds x K, not D.
                        Windows cross to the card through pinned buffers
                        with non-blocking copies; a window read on the
                        background fetch thread is copied on a stream of
                        the store's own, and the reader's stream waits on
                        that copy's event.

Both tiers carry per-client error-feedback residuals (f32, zeros for
clients the wire never touched) and round-staleness counters
(``last_round`` / ``staleness``).
"""
from __future__ import annotations

import atexit
import contextlib
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (
    CheckpointCorruptionError, load_leaves, save_checkpoint,
)
from repro_torch.kernels import ops as kernel_ops

#: footprint (bytes of [D, sum(sizes)] at f32) above which ``make_store``
#: refuses to materialize a resident buffer and drops to the cold tier
MEMORY_TIER_MAX_BYTES = 2 ** 31

#: every live prefetch pool, so interpreter exit never hangs on a
#: forgotten fetch thread. A WeakSet: registration must not keep a
#: collected store's pool alive.
_LIVE_FETCH_POOLS: "weakref.WeakSet[ThreadPoolExecutor]" = weakref.WeakSet()


@atexit.register
def _shutdown_fetch_pools() -> None:
    for pool in list(_LIVE_FETCH_POOLS):
        pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# host <-> card copies through pinned buffers
# ---------------------------------------------------------------------------

def stream_ctx(stream):
    """``torch.cuda.stream(stream)``, or no context for None (the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else \
        contextlib.nullcontext()


def _record_event(stream=None):
    """A card event recorded on ``stream`` (default: the current one)."""
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def pinned_empty(shape, dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    """A host buffer for rows bound to ``device``: pinned when that is the
    card (so the copy may run without the host waiting), plain otherwise."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


class HostCopy:
    """A card -> host copy in flight: ``src`` is copied into a pinned
    buffer with ``non_blocking=True`` on ``stream`` (default: the current
    stream; a given stream first waits for the current one's work). The
    rows may be read only through ``numpy()``, which waits on the copy's
    event: a read before it would see stale bytes without any error."""

    def __init__(self, src: torch.Tensor, stream=None):
        self.tensor = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(src.device))
            src.record_stream(stream)
        with stream_ctx(stream):
            self.tensor.copy_(src, non_blocking=True)
            self.event = _record_event()

    def numpy(self) -> np.ndarray:
        self.event.synchronize()
        return self.tensor.numpy()


def rows_to_numpy(rows, dtype) -> np.ndarray:
    """The host view of a window handed to a host-side scatter: a
    ``HostCopy`` waits on its event, a CUDA tensor goes through a pinned
    non-blocking copy and its event, a CPU tensor is viewed."""
    if isinstance(rows, torch.Tensor) and rows.device.type == "cuda":
        rows = HostCopy(rows.detach())
    if isinstance(rows, HostCopy):
        out = rows.numpy()
    elif isinstance(rows, torch.Tensor):
        out = rows.detach().numpy()
    else:
        out = np.asarray(rows)
    return out.astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# prefetch handles
# ---------------------------------------------------------------------------

class PrefetchHandle:
    """An in-flight window read issued by ``ClientStateStore.prefetch``.
    ``result(timeout=)`` blocks until the [K, width] rows are available
    and returns them, usable on the caller's current stream
    (``TimeoutError`` if the fetch is stuck past the timeout; a
    worker-side exception re-raises here); calling it twice returns the
    same rows. ``wait()`` is the no-timeout alias."""

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        raise NotImplementedError

    def wait(self) -> torch.Tensor:
        return self.result()


class _ReadyPrefetch(PrefetchHandle):
    """Device tier: the gather was already enqueued on the caller's
    stream, which orders it after every earlier scatter."""

    def __init__(self, rows):
        self._rows = rows

    def result(self, timeout: Optional[float] = None):
        return self._rows


class _ThreadPrefetch(PrefetchHandle):
    """Cold tier: the gather runs on the background fetch thread, its copy
    to the card on the store's fetch stream. ``result`` makes the caller's
    stream wait on that copy's event and marks the rows as used there (so
    the caching allocator does not reuse them while the caller's work
    still reads them). A worker-side exception re-raises out of
    ``result()`` and is marked consumed on the owning store, so the
    store's rethrow-on-next-use does not raise it twice."""

    def __init__(self, future, owner=None):
        self._future = future
        self._owner = owner

    def result(self, timeout: Optional[float] = None):
        try:
            rows, event = self._future.result(timeout)
        except (_FutureTimeout, TimeoutError):
            raise
        except BaseException as e:
            if self._owner is not None:
                self._owner._consume_worker_error(e)
            raise
        if event is not None:
            stream = torch.cuda.current_stream(rows.device)
            stream.wait_event(event)
            rows.record_stream(stream)
        return rows


# ---------------------------------------------------------------------------
# the tiers
# ---------------------------------------------------------------------------

class ClientStateStore:
    """Base contract: [D, width] persistent per-client rows + residuals +
    staleness. ``gather``/``scatter`` move [K, width] windows; ids are host
    arrays (the selection is read back before the window is fetched)."""

    #: optional ``repro_torch.faults.FaultInjector``; tiers with real
    #: failure surfaces (file reads, the fetch thread) call its hooks.
    #: None = no injection — the default on every tier.
    fault_injector = None
    #: cumulative count of retried store reads (checkpoint tier only)
    read_retry_count = 0

    def __init__(self, num_enrolled: int, width: int):
        if num_enrolled <= 0:
            raise ValueError(f"ClientStateStore: num_enrolled must be "
                             f"positive, got {num_enrolled}")
        self.num_enrolled = int(num_enrolled)
        self.width = int(width)
        #: [D] round index each client last trained in; -1 = never touched
        self.last_round = np.full((self.num_enrolled,), -1, np.int32)

    def close(self) -> None:
        """Release background resources (fetch threads). No-op on tiers
        without any; safe to call twice."""

    # -- window movement ---------------------------------------------------
    def gather(self, ids) -> torch.Tensor:
        """[K, width] rows for the active ids."""
        raise NotImplementedError

    def scatter(self, ids, rows) -> None:
        """Write the mixed [K, width] window back at the active ids."""
        raise NotImplementedError

    # -- prefetch (the pipelined engine's stage A) ----------------------------
    def prefetch(self, ids) -> PrefetchHandle:
        """Start fetching the [K, width] window for ``ids``. The base
        implementation enqueues the gather at once on the current stream
        — correct for every tier and already overlapping for device tiers.
        Tiers whose gather blocks the host override this with a thread."""
        return _ReadyPrefetch(self.gather(ids))

    def prefetch_residual(self, ids) -> PrefetchHandle:
        """``prefetch`` for the codec residual tier."""
        return _ReadyPrefetch(self.gather_residual(ids))

    # -- write-back (the pipelined engine's stage C) ---------------------------
    def write_back(self, ids, rows, residual=None) -> PrefetchHandle:
        """Scatter a mixed window (and, given, its residual rows) back; the
        handle's ``result()`` returns once it has landed. The base
        implementation scatters at once (on the current stream for device
        tiers). Tiers whose scatter blocks the host override this with the
        fetch thread, in submission order with the prefetches."""
        if residual is not None:
            self.scatter_residual(ids, residual)
        self.scatter(ids, rows)
        return _ReadyPrefetch(None)

    # -- readout -------------------------------------------------------------
    def resident_flat(self) -> Optional[torch.Tensor]:
        """The live [D, width] buffer if this tier keeps one, else None."""
        return None

    def consensus(self) -> np.ndarray:
        """[width] mean over all enrolled rows (the global-model readout)."""
        raise NotImplementedError

    # -- per-client codec residuals -------------------------------------------
    def gather_residual(self, ids) -> torch.Tensor:
        """[K, width] f32 error-feedback residuals (zeros for clients the
        wire never touched)."""
        raise NotImplementedError

    def scatter_residual(self, ids, rows) -> None:
        raise NotImplementedError

    # -- staleness -------------------------------------------------------------
    def _check_ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        if ids.ndim != 1:
            raise ValueError(f"store ids must be 1-D, got shape {ids.shape}")
        bad = ids[(ids < 0) | (ids >= self.num_enrolled)]
        if bad.size:
            raise IndexError(
                f"store ids {bad[:4].tolist()} out of range for "
                f"num_enrolled={self.num_enrolled}")
        return ids

    def touch(self, ids, round_index: int) -> None:
        """Mark the active ids as trained in ``round_index``."""
        self.last_round[self._check_ids(ids)] = int(round_index)

    def staleness(self, round_index: int) -> np.ndarray:
        """[D] rounds since each client last trained (never-touched clients
        read ``round_index + 1``)."""
        return np.asarray(int(round_index) - self.last_round, np.int32)


class MemoryStore(ClientStateStore):
    """Resident tier: the full [D, width] packed state as ONE tensor on
    its device, windowed through ``gather_rows_dev`` / ``scatter_rows_dev``
    (an in-place ``index_copy_``)."""

    def __init__(self, flat: torch.Tensor, *, residual: bool = False):
        if getattr(flat, "ndim", 0) != 2:
            raise ValueError(
                f"MemoryStore: expected a packed [D, sum(sizes)] buffer, "
                f"got shape {tuple(getattr(flat, 'shape', ()))}")
        super().__init__(flat.shape[0], flat.shape[1])
        self._flat = flat
        self._residual = (torch.zeros(flat.shape, dtype=torch.float32,
                                      device=flat.device)
                          if residual else None)

    @property
    def flat(self) -> torch.Tensor:
        """The live [D, width] buffer."""
        return self._flat

    @property
    def device(self) -> torch.device:
        return self._flat.device

    def resident_flat(self) -> torch.Tensor:
        return self._flat

    def gather(self, ids) -> torch.Tensor:
        return kernel_ops.gather_rows_dev(self._flat, self._check_ids(ids))

    def scatter(self, ids, rows) -> None:
        kernel_ops.scatter_rows_dev(self._flat, self._check_ids(ids),
                                    torch.as_tensor(rows))

    def _residual_tier(self, what: str) -> torch.Tensor:
        if self._residual is None:
            raise ValueError(f"MemoryStore was built without residual=True; "
                             f"no codec residual tier to {what}")
        return self._residual

    def gather_residual(self, ids) -> torch.Tensor:
        return kernel_ops.gather_rows_dev(self._residual_tier("gather"),
                                          self._check_ids(ids))

    def scatter_residual(self, ids, rows) -> None:
        kernel_ops.scatter_rows_dev(self._residual_tier("scatter"),
                                    self._check_ids(ids),
                                    torch.as_tensor(rows))

    def consensus(self) -> np.ndarray:
        return self._flat.to(torch.float32).mean(dim=0).cpu().numpy()


class CheckpointStore(ClientStateStore):
    """Cold tier: untouched clients hold a shared base row implicitly;
    touched rows live in a host overlay dict. ``base`` is either a [width]
    row (fresh enrollment: every client starts at the global init) or a
    path to an npz checkpoint holding one [D, width] leaf, whose rows are
    fetched on demand with ``checkpoint.io.load_leaves`` partial-row reads.
    Gathered windows land on ``device`` (default: the CPU)."""

    def __init__(self, base, num_enrolled: int, *, width: Optional[int] = None,
                 dtype=np.float32, read_retries: int = 0,
                 read_backoff: float = 0.0, device="cpu"):
        if isinstance(base, (str, os.PathLike)):
            self._base_path: Optional[str] = os.fspath(base)
            self._base_row: Optional[np.ndarray] = None
            if width is None:
                probe, _ = load_leaves(self._base_path, np.array([0]))
                width = probe[0].shape[-1]
                dtype = probe[0].numpy().dtype
        else:
            row = (base.detach().cpu().numpy()
                   if isinstance(base, torch.Tensor) else np.asarray(base))
            if row.ndim != 1:
                raise ValueError(
                    f"CheckpointStore: base must be a [sum(sizes)] row or an "
                    f"npz path, got shape {row.shape}")
            self._base_path = None
            self._base_row = row
            width, dtype = row.shape[0], row.dtype
        super().__init__(num_enrolled, width)
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        #: touched rows only: {client id -> [width] np row}
        self._overlay: Dict[int, np.ndarray] = {}
        self._residual_overlay: Dict[int, np.ndarray] = {}
        #: lazily started background fetch thread for ``prefetch``; one
        #: worker, so prefetches stay ordered
        self._executor: Optional[ThreadPoolExecutor] = None
        #: the fetch thread's stream for its copies to the card (lazy)
        self._fetch_stream = None
        #: a failed base read is retried up to ``read_retries`` times with
        #: exponential backoff (base seconds ``read_backoff``);
        #: ``CheckpointCorruptionError`` is permanent and never retried
        self.read_retries = int(read_retries)
        self.read_backoff = float(read_backoff)
        self.read_retry_count = 0
        #: a fetch-worker exception nobody collected via ``result()``,
        #: re-raised at the store's next use instead of being lost
        self._worker_error: Optional[BaseException] = None
        #: one that ``result()`` collected before the future's done-callback
        #: ran on the worker (the future wakes its waiters first): the
        #: callback drops it instead of keeping it for a rethrow
        self._collected_error: Optional[BaseException] = None
        self._error_lock = threading.Lock()

    def _fetch_pool(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="store-prefetch")
            _LIVE_FETCH_POOLS.add(self._executor)
        return self._executor

    def close(self) -> None:
        """Shut down the background fetch pool (queued fetches are
        cancelled, a running one completes). Idempotent; a later
        ``prefetch`` restarts the pool."""
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
            _LIVE_FETCH_POOLS.discard(self._executor)
            self._executor = None

    # -- worker-error bookkeeping (rethrow-on-next-use) ----------------------
    def _on_fetch_done(self, future) -> None:
        if future.cancelled():
            return
        exc = future.exception()
        if exc is not None:
            with self._error_lock:
                if exc is self._collected_error:
                    self._collected_error = None
                elif self._worker_error is None:
                    self._worker_error = exc

    def _consume_worker_error(self, exc: BaseException) -> None:
        with self._error_lock:
            if self._worker_error is exc:
                self._worker_error = None
            else:           # its done-callback has not run yet
                self._collected_error = exc

    def _raise_pending_worker_error(self) -> None:
        with self._error_lock:
            exc, self._worker_error = self._worker_error, None
        if exc is not None:
            raise RuntimeError(
                "CheckpointStore: a previous prefetch worker died and its "
                "error was never collected (call PrefetchHandle.result())"
            ) from exc

    def _submit(self, job, *args) -> PrefetchHandle:
        self._raise_pending_worker_error()
        if self.device.type == "cuda" and self._fetch_stream is None:
            self._fetch_stream = torch.cuda.Stream(self.device)
        future = self._fetch_pool().submit(job, *args)
        future.add_done_callback(self._on_fetch_done)
        return _ThreadPrefetch(future, self)

    def _fetch_job(self, fn, ids):
        """Runs ON the fetch worker: the fault hook first (an injected
        delay or worker death lands here), then the gather, whose copy to
        the card goes on the fetch stream; returns (rows, its event)."""
        if self.fault_injector is not None:
            self.fault_injector.on_prefetch()
        with stream_ctx(self._fetch_stream):
            rows = fn(ids)
            event = (_record_event() if self._fetch_stream is not None
                     else None)
        return rows, event

    def prefetch(self, ids) -> PrefetchHandle:
        """Background-thread gather: safe against a concurrent ``scatter``
        because ``gather`` only does per-id ``dict.get`` reads (it never
        iterates the overlay) and ``scatter`` replaces whole rows. A racing
        read of a conflicting id may return the pre-scatter row — the
        pipelined engine detects id overlaps on the host and patches those
        rows before use."""
        return self._submit(self._fetch_job, self.gather,
                            self._check_ids(ids))

    def prefetch_residual(self, ids) -> PrefetchHandle:
        return self._submit(self._fetch_job, self.gather_residual,
                            self._check_ids(ids))

    def write_back(self, ids, rows, residual=None) -> PrefetchHandle:
        """The scatter on the fetch thread, behind every job submitted
        before it: its wait on the rows' copy to the host and the overlay
        writes leave the caller's thread, which goes on launching the next
        window. A prefetch submitted after it sees its rows. ``rows`` (and
        ``residual``) may be ``HostCopy``s still in flight."""
        return self._submit(self._write_job, self._check_ids(ids), rows,
                            residual)

    def _write_job(self, ids, rows, residual):
        if residual is not None:
            self.scatter_residual(ids, residual)
        self.scatter(ids, rows)
        return None, None

    @property
    def num_touched(self) -> int:
        return len(self._overlay)

    def _base_rows(self, ids: np.ndarray) -> np.ndarray:
        """One base read, retried: transient ``OSError``s (a flaky disk, an
        injected fault) are retried up to ``read_retries`` times with
        exponential backoff; ``CheckpointCorruptionError`` (bad bytes: a
        retry re-reads the same bytes) raises through at once."""
        attempt = 0
        while True:
            try:
                return self._base_rows_once(ids)
            except CheckpointCorruptionError:
                raise
            except OSError:
                if attempt >= self.read_retries:
                    raise
                if self.read_backoff > 0.0:
                    time.sleep(self.read_backoff * (2 ** attempt))
                attempt += 1
                self.read_retry_count += 1

    def _base_rows_once(self, ids: np.ndarray) -> np.ndarray:
        if self.fault_injector is not None:
            self.fault_injector.on_read()
        if self._base_row is not None:
            return np.broadcast_to(self._base_row, (ids.size, self.width))
        leaves, _ = load_leaves(self._base_path, ids)
        return leaves[0].numpy()

    def _window(self, ids: np.ndarray, overlay, base_rows, dtype):
        """Fill a host buffer (pinned for the card) with the overlay's rows
        and, for the rest, ``base_rows(their ids)`` (zeros when None); then
        copy it to the store's device without the host waiting."""
        buf = pinned_empty((ids.size, self.width),
                           torch.from_numpy(np.empty(0, dtype)).dtype,
                           self.device)
        out = buf.numpy()
        cold = []
        for i, c in enumerate(ids):
            row = overlay.get(int(c))
            if row is None:
                cold.append(i)
            else:
                out[i] = row
        if cold:
            if base_rows is None:
                out[cold] = 0.0
            else:
                out[cold] = base_rows(ids[cold])
        return buf.to(self.device, non_blocking=True)

    def gather(self, ids) -> torch.Tensor:
        return self._window(self._check_ids(ids), self._overlay,
                            self._base_rows, self.dtype)

    def scatter(self, ids, rows) -> None:
        ids = self._check_ids(ids)
        rows = rows_to_numpy(rows, self.dtype)
        if rows.shape != (ids.size, self.width):
            raise ValueError(
                f"CheckpointStore.scatter: window shape {rows.shape} does "
                f"not match ({ids.size}, {self.width})")
        for i, c in enumerate(ids):
            self._overlay[int(c)] = rows[i].copy()

    def gather_residual(self, ids) -> torch.Tensor:
        return self._window(self._check_ids(ids), self._residual_overlay,
                            None, np.float32)

    def scatter_residual(self, ids, rows) -> None:
        ids = self._check_ids(ids)
        rows = rows_to_numpy(rows, np.float32)
        for i, c in enumerate(ids):
            self._residual_overlay[int(c)] = rows[i].copy()

    def consensus(self) -> np.ndarray:
        """[width] mean over all enrolled rows without materializing them:
        touched rows sum explicitly in float64, the (D - touched)
        untouched clients contribute the base row analytically. Needs a
        base *row* (a checkpoint-backed base would need a full pass)."""
        if self._base_row is None:
            raise NotImplementedError(
                "consensus over a checkpoint-backed base requires a full "
                "pass over the state file; hold a base row instead")
        acc = np.zeros((self.width,), np.float64)
        for row in self._overlay.values():
            acc += np.asarray(row, np.float64)
        acc += (self.num_enrolled - len(self._overlay)) * np.asarray(
            self._base_row, np.float64)
        return (acc / self.num_enrolled).astype(self.dtype)

    def save(self, ckpt_dir: str, step: int) -> str:
        """Materialize overlay + base into one [D, width] checkpoint — only
        sensible at small D (tests, tier migration)."""
        full = np.broadcast_to(self._base_row,
                               (self.num_enrolled, self.width)).copy()
        for c, row in self._overlay.items():
            full[c] = row
        return save_checkpoint(ckpt_dir, step, {"state": full},
                               metadata={"num_enrolled": self.num_enrolled})


def make_store(base_row, num_enrolled: int, *, tier: str = "auto",
               residual: bool = False, read_retries: int = 0,
               read_backoff: float = 0.0) -> ClientStateStore:
    """Build the right tier for D=``num_enrolled`` clients all starting at
    ``base_row`` ([sum(sizes)], the packed global init, a tensor on the
    engine's device): a resident ``MemoryStore`` on that device while
    [D, width] fits ``MEMORY_TIER_MAX_BYTES``, the overlay-backed
    ``CheckpointStore`` (windows delivered to that device) beyond."""
    if tier not in ("auto", "memory", "checkpoint"):
        raise ValueError(f"unknown store tier {tier!r}; expected one of "
                         "auto, memory, checkpoint")
    row = torch.as_tensor(base_row)
    if row.ndim != 1:
        raise ValueError(f"make_store: base_row must be a packed "
                         f"[sum(sizes)] row, got shape {tuple(row.shape)}")
    nbytes = int(num_enrolled) * int(row.shape[0]) * row.element_size()
    if residual:                       # the f32 residual tier rides along
        nbytes += int(num_enrolled) * int(row.shape[0]) * 4
    if tier == "memory" or (tier == "auto" and nbytes <= MEMORY_TIER_MAX_BYTES):
        flat = row[None].expand(int(num_enrolled), row.shape[0]).contiguous()
        return MemoryStore(flat, residual=residual)
    return CheckpointStore(row, num_enrolled, read_retries=read_retries,
                           read_backoff=read_backoff, device=row.device)
