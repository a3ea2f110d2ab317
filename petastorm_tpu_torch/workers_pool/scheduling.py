"""Adaptive out-of-order dispatch, the reorder stage and the autotuner.

Counterpart of ``petastorm_tpu/workers_pool/scheduling.py``, whole:

* :class:`PieceCostModel`: an online per-piece EWMA of decode wall time,
  keyed by global piece index, seeded from row-group sizes (compressed
  byte sizes from a footer scan, else row counts) so that epoch 0 already
  ranks pieces; every pool ack refines it.
* :class:`AdaptiveDispatchPolicy`: within a bounded lookahead window of the
  epoch permutation, predicted-slow pieces launch first while the fast
  ones flow in epoch order; a lag bound keeps any position from being
  overtaken by more than ``window`` later dispatches.
  :class:`FifoDispatchPolicy` is the epoch order, front to back.
* :class:`ReorderBuffer`: restores the epoch-order delivery on the result
  path, so shuffle determinism, resume tokens and elastic reshards do not
  change with the processing order.
* :class:`Autotuner`: moves the lookahead window, the in-flight bound, the
  loader's prefetch and the ingest plane's readahead window from measured
  stage quantiles and, when attached, a ``StallMonitor``'s wait fraction;
  clamped, rate-limited, each move a ``sched_*`` gauge and a record in the
  decision journal (:mod:`petastorm_tpu_torch.telemetry.decisions`).

``'auto'`` resolves to FIFO for small datasets and one-worker pools, and
``PETASTORM_TPU_NO_ADAPTIVE_SCHED=1`` forces FIFO everywhere.  Standard
library only: the process pool's children import the pools.
"""

import os
import threading
import time

from petastorm_tpu_torch.telemetry import decisions as _decisions

__all__ = ['PieceCostModel', 'FifoDispatchPolicy', 'AdaptiveDispatchPolicy',
           'ReorderBuffer', 'Autotuner', 'SchedulerKnobs',
           'resolve_scheduling', 'SCHEDULING_MODES', 'piece_weights']

SCHEDULING_MODES = ('auto', 'fifo', 'adaptive')

#: ``'auto'`` stays FIFO below this many work items: the lookahead
#: window needs room to reorder anything, and the timing signal never
#: amortizes on a handful of pieces.
MIN_ITEMS_FOR_ADAPTIVE = 8

#: Autotuner clamps — the decision space is a box, never a runaway.
MIN_WINDOW, MAX_WINDOW = 8, 256
MIN_INFLIGHT, MAX_INFLIGHT = 4, 128
MIN_PREFETCH, MAX_PREFETCH = 2, 8
#: ...including the ingest plane's readahead window: how many
#: pieces' byte ranges may sit fetched-or-fetching ahead of decode.
MIN_INGEST_WINDOW, MAX_INGEST_WINDOW = 2, 64
DEFAULT_INGEST_WINDOW = 8

#: Decode blocked on an in-flight ingest fetch for more than this many
#: seconds inside one tuning window means the readahead is too shallow —
#: hidden latency waits nowhere.
INGEST_WAIT_GROW_S = 0.05

#: decode p99/p50 above this reads as cost skew worth reordering for
#: (log2 histogram buckets: 8x is three buckets of genuine spread).
SKEW_RATIO_FLOOR = 8.0

#: The epoch-0 byte-size prior costs one footer open per data FILE; past
#: this many files in the shard the per-file opens dominate reader
#: startup (a remote object store pays a GET each — ~30 s added to
#: time-to-first-batch on a 10k-file dataset), so the prior falls back
#: to the zero-I/O row counts and the EWMA learns real costs from the
#: first acks instead.
MAX_PRIOR_SCAN_FILES = 512

#: A piece is classified SLOW (launched early, out of order) when its
#: predicted cost is at least this many times the pending median.
#: Everything below dispatches in epoch order — reordering equal-cost
#: pieces would only pin in-flight slots until their delivery turn.
SLOW_FACTOR = 4.0


def resolve_scheduling(mode, num_items, workers_count):
    """``'auto'``/``'fifo'``/``'adaptive'`` -> the effective mode.

    The kill switch (``PETASTORM_TPU_NO_ADAPTIVE_SCHED=1``) wins over
    everything, including an explicit ``'adaptive'`` — it exists for
    production incident response, where "the knob is definitely off"
    beats argument archaeology.
    """
    if mode not in SCHEDULING_MODES:
        raise ValueError("scheduling must be one of %s; got %r"
                         % (', '.join(repr(m) for m in SCHEDULING_MODES),
                            mode))
    if os.environ.get('PETASTORM_TPU_NO_ADAPTIVE_SCHED') == '1':
        return 'fifo'
    if mode == 'auto':
        if workers_count <= 1 or num_items < MIN_ITEMS_FOR_ADAPTIVE:
            return 'fifo'
        return 'adaptive'
    return mode


class PieceCostModel(object):
    """Per-piece EWMA of decode wall time, with a size-proxy prior.

    Predictions only ever RANK pieces against each other, so the prior
    (row counts or byte sizes — any consistent size proxy) and the
    observed seconds never need a common unit: observed timings simply
    replace the prior per piece as acks arrive.  Thread-safe — the
    ventilator thread reads predictions while pool worker threads (or
    the parent's ack path) write observations.
    """

    def __init__(self, alpha=0.3):
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma = {}    # piece -> observed EWMA seconds
        #: running sum of ``_ewma`` values, maintained by observe() so
        #: predict() gets the observed mean in O(1) — summing the dict
        #: per call made epoch-0 admission O(n^2) under the lock every
        #: ack contends on.  Float drift is irrelevant: predictions
        #: only rank pieces against each other.
        self._ewma_sum = 0.0
        self._prior = {}   # piece -> relative size weight
        self._prior_mean = 0.0
        self.observations = 0

    def seed(self, weights):
        """Size-proxy priors for epoch 0 (piece -> relative weight)."""
        with self._lock:
            self._prior = {k: float(v) for k, v in weights.items()
                           if v is not None and v > 0}
            self._prior_mean = (sum(self._prior.values()) / len(self._prior)
                                if self._prior else 0.0)

    def observe(self, piece, seconds):
        with self._lock:
            prev = self._ewma.get(piece)
            value = (seconds if prev is None
                     else prev + self._alpha * (seconds - prev))
            self._ewma[piece] = value
            self._ewma_sum += value - (prev or 0.0)
            self.observations += 1

    def skew_ratio(self, min_pieces=8):
        """p99/p50 over the observed per-piece EWMAs, or None below
        ``min_pieces`` observed pieces.  The pool-agnostic skew signal:
        parent-side ``decode`` histograms are never observed for process
        pools (children keep their own registries), but the cost model
        rides every ack regardless of pool type."""
        with self._lock:
            values = sorted(self._ewma.values())
        if len(values) < min_pieces:
            return None
        p50 = values[len(values) // 2]
        p99 = values[min(len(values) - 1,
                         int(round(0.99 * (len(values) - 1))))]
        return (p99 / p50) if p50 else None

    def predict(self, piece):
        """Predicted relative cost.  Observed pieces report seconds;
        unobserved pieces report their prior scaled into the observed
        scale (or the raw prior weight before any timing exists) —
        either way a single consistent ranking."""
        with self._lock:
            observed = self._ewma.get(piece)
            if observed is not None:
                return observed
            observed_mean = (self._ewma_sum / len(self._ewma)
                             if self._ewma else None)
            prior = self._prior.get(piece)
            if prior is None:
                # unknown piece: rank at the observed mean (neutral)
                return (observed_mean if observed_mean is not None
                        else self._prior_mean)
            if observed_mean is not None and self._prior_mean:
                return prior * (observed_mean / self._prior_mean)
            return prior


class FifoDispatchPolicy(object):
    """The legacy order: epoch permutation, front to back."""

    adaptive = False
    #: The ventilator snapshots this after every next() into its
    #: dispatch meta; FIFO has no decision to record.
    last_dispatch_meta = None

    def begin_epoch(self, order, base_position, start_cursor):
        self._order = order
        self._base = base_position
        self._cursor = start_cursor

    def next(self, force_oldest=False):
        if self._cursor >= len(self._order):
            return None
        idx = self._cursor
        self._cursor = idx + 1
        return self._base + idx, self._order[idx]

    def oldest_undispatched_idx(self):
        return self._cursor

    def observe(self, item, elapsed):
        pass


class AdaptiveDispatchPolicy(object):
    """Cost-aware out-of-order dispatch within a bounded window.

    MinatoLoader's processing model (PAPERS.md) adapted to a pull-based
    ventilator: classify pending pieces online into SLOW (predicted
    cost at least :data:`SLOW_FACTOR` times the pending median) and
    fast, launch slow pieces earliest (most expensive first) so their
    cost overlaps everything else, and keep the fast pieces flowing in
    epoch order — the in-order fast stream IS the reserve that
    backfills every stall window, and in-order dispatch is what lets
    their delivery slots recycle immediately (reordering equal-cost
    pieces would only pin in-flight slots until their delivery turn).

    Each ``next()`` admits epoch-order items into a pending window of
    ``window`` undispatched positions and picks:

    1. the OLDEST pending position, when ``force_oldest`` is set (the
       ventilator's last-slot liveness rule) or when it has been
       overtaken by ``window`` later dispatches (the lag bound — caps
       any piece's delivery latency);
    2. otherwise the most expensive SLOW piece;
    3. otherwise (no slow pending) the oldest — fast pieces in exact
       epoch order.

    Work items are ``(piece_index, ...)`` tuples (the reader's shape)
    or opaque objects; the cost key is ``item[0]`` when indexable.
    ``window`` is written by the autotuner from another thread — single
    attribute assignment, read once per dispatch.
    """

    adaptive = True

    def __init__(self, cost_model, window=64, early_limit=None):
        self.cost_model = cost_model
        self.window = max(2, int(window))
        #: at most this many slow pieces may run AHEAD of the dispatch
        #: frontier at once (None = unlimited).  Front-loading every
        #: worker with slow pieces would stall delivery (and the
        #: consumer overlap) until the first one lands — some of the
        #: pool must keep serving the in-order fast stream.
        self.early_limit = early_limit
        #: Last dispatch's decision, snapshotted by the ventilator into
        #: the position's dispatch meta.  Read under the same dispatch
        #: lock next() runs under.
        self.last_dispatch_meta = None

    @staticmethod
    def _piece_key(item):
        try:
            return item[0]
        except (TypeError, KeyError, IndexError):
            return item

    def begin_epoch(self, order, base_position, start_cursor):
        self._order = order
        self._base = base_position
        self._admit = start_cursor      # next epoch-order index to admit
        self._pending = {}              # idx -> item
        self._entered = {}              # idx -> dispatch seq at admission
        self._costs = {}                # idx -> predicted cost at admission
        self._early = set()             # slow idxs running ahead of frontier
        self._seq = 0

    def next(self, force_oldest=False):
        window = max(2, int(self.window))
        n = len(self._order)
        while self._admit < n and len(self._pending) < window:
            item = self._order[self._admit]
            self._pending[self._admit] = item
            self._entered[self._admit] = self._seq
            # cost snapshots at ADMISSION: one predict() per piece per
            # epoch instead of O(window) per dispatch — next() runs
            # under the ventilator dispatch lock, and per-dispatch
            # re-prediction would put window-many cost-model lock
            # acquisitions on the path every ack contends with.  Fresh
            # observations refine the ranking from the next admission
            # (and epoch) on; a pending piece's class rarely flips
            # mid-window.
            self._costs[self._admit] = self.cost_model.predict(
                self._piece_key(item))
            self._admit += 1
        if not self._pending:
            return None
        oldest = min(self._pending)
        early_pick = False
        # early slow pieces stop counting once the in-order stream has
        # caught up to them (their delivery turn is imminent)
        self._early = {s for s in self._early if s > oldest}
        if force_oldest or self._seq - self._entered[oldest] >= window:
            # force_oldest: the ventilator's LAST in-flight slot always
            # goes to the delivery frontier — under ack-on-delivery this
            # is the liveness rule (a saturated window must contain the
            # position delivery is waiting on, or nothing ever acks)
            idx = oldest
        else:
            costs = self._costs
            ranked = sorted(self._pending, key=lambda i: (costs[i], -i))
            median = costs[ranked[len(ranked) // 2]]
            # SLOW_FACTOR is also the degenerate-cost-model guard: when
            # everything looks equally expensive nothing clears 4x the
            # median, so dispatch stays exact epoch order instead of
            # devolving into reverse-cost order
            slow = [i for i in ranked
                    if median > 0 and costs[i] >= SLOW_FACTOR * median]
            if slow and (self.early_limit is None
                         or len(self._early) < self.early_limit):
                # most expensive slow piece first (ties: oldest)
                idx = slow[-1]
                if idx != oldest:
                    self._early.add(idx)
                    early_pick = True
            else:
                # exact epoch order — the fast-backfill stream
                idx = oldest
        item = self._pending.pop(idx)
        self._entered.pop(idx, None)
        predicted = self._costs.pop(idx, None)
        self._seq += 1
        self.last_dispatch_meta = {'policy': 'adaptive',
                                   'early': early_pick,
                                   # relative cost (seconds once observed,
                                   # size-prior units before): predictions
                                   # only RANK pieces, see PieceCostModel
                                   'predicted_cost': (round(predicted, 6)
                                                      if predicted is not None
                                                      else None)}
        return self._base + idx, item

    def oldest_undispatched_idx(self):
        if self._pending:
            return min(self._pending)
        return self._admit

    def observe(self, item, elapsed):
        self.cost_model.observe(self._piece_key(item), elapsed)


class ReorderBuffer(object):
    """Restores ascending-position (== ``epoch_order``) delivery.

    Positions form two consecutive integer runs: the prologue
    (``-prologue_count .. -1``, elastic-reshard handoff work) and the
    epoch run from ``start_position`` upward (epochs are dense:
    ``epoch*n + cursor``).  Results buffer per position until every
    earlier position has COMPLETED, then release in order — a position
    may hold several results (row lists) or none (predicate dropped the
    group).

    The ventilator ack is DEFERRED to release (ack-on-delivery): pools
    ack each position as :meth:`complete` releases it, so the
    ventilator's in-flight bound counts *undelivered* positions — that
    bound IS the reorder-buffer depth bound (held results can never
    outrun it), and the oldest-outstanding resume token becomes exactly
    the delivery frontier.

    Thread-safe; :meth:`complete` returns the newly releasable
    ``(position, elapsed, [result, ...])`` runs so the caller controls
    publication order (and acks each position after publishing it).
    """

    def __init__(self, start_position=0, prologue_count=0):
        self._lock = threading.Lock()
        self._start = int(start_position)
        self._expected = (-int(prologue_count) if prologue_count
                          else self._start)
        self._results = {}    # position -> [result, ...]
        self._done = {}       # completed, unreleased position -> elapsed
        self._n_results = 0

    def _advance(self):
        self._expected += 1
        if self._expected == 0 and self._start > 0:
            # prologue run exhausted: jump to the epoch run
            self._expected = self._start

    def add(self, position, result):
        with self._lock:
            self._results.setdefault(position, []).append(result)
            self._n_results += 1

    def complete(self, position, elapsed=None):
        """Mark ``position`` fully processed; return the newly
        deliverable ``(position, elapsed, results)`` runs, in delivery
        order (possibly empty)."""
        released = []
        with self._lock:
            self._done[position] = elapsed
            while self._expected in self._done:
                run_elapsed = self._done.pop(self._expected)
                results = self._results.pop(self._expected, [])
                released.append((self._expected, run_elapsed, results))
                self._n_results -= len(results)
                self._advance()
        return released

    def release(self, position, elapsed, publish, ventilator=None):
        """Complete ``position`` and run the release-then-ack drain
        invariant — THE one copy all three pools share: publish each
        newly deliverable result in epoch order, THEN ack its position
        to the ventilator with its own wall time (the cost-model plumb).
        Ack strictly after publish: an ack before the result is visible
        would let a checkpoint drain see the in-flight bound clear while
        the result is still unpublished."""
        for pos, pos_elapsed, results in self.complete(position, elapsed):
            for result in results:
                publish(result)
            if ventilator is not None:
                ventilator.processed_item(pos, pos_elapsed)

    @property
    def pending_results(self):
        """Buffered results awaiting an earlier position (gauge)."""
        with self._lock:
            return self._n_results

    @property
    def pending_positions(self):
        with self._lock:
            return len(self._results) + len(self._done)

    def empty(self):
        with self._lock:
            return not self._results and not self._done


class SchedulerKnobs(object):
    """The mutable decision surface the autotuner writes: live views
    onto the ventilation window, the ventilator in-flight bound, and
    the loader prefetch depth.  Owners register setters; unclaimed
    knobs are tuned but unapplied (the gauges still tell the story)."""

    def __init__(self, window=64, max_inflight=16, prefetch=2,
                 ingest_window=DEFAULT_INGEST_WINDOW):
        self.window = int(window)
        self.max_inflight = int(max_inflight)
        self.prefetch = int(prefetch)
        self.ingest_window = int(ingest_window)
        self._setters = {}

    def bind(self, name, setter):
        self._setters[name] = setter
        setter(getattr(self, name))

    def apply(self, name, value):
        setattr(self, name, int(value))
        setter = self._setters.get(name)
        if setter is not None:
            setter(int(value))


class Autotuner(object):
    """Measurement-driven knob adjustment (tf.data AUTOTUNE, PAPERS.md).

    Runs inline on the consumer path (no thread — periodic threads burn
    measurable CPU on virtualized kernels): callers invoke
    :meth:`maybe_tune` per batch; it no-ops until ``interval_s`` has
    passed AND ``min_observations`` new cost-model samples arrived.
    Each decision multiplies a knob by a small step, clamps into the
    documented box, and exports the result as telemetry gauges
    (``sched_window`` / ``sched_max_inflight`` / ``sched_prefetch``,
    plus the ``sched_adjust_total`` counter).

    Signals, strongest first:

    * attached ``StallMonitor`` wait fraction over the window — the
      consumer actually starving is the ground truth;
    * decode p99/p50 skew ratio — reordering headroom exists;
    * host_batch vs device_put p99 — which side of the boundary is
      slow (prefetch only hides DELIVERY jitter, not decode deficit).
    """

    def __init__(self, registry=None, cost_model=None, interval_s=2.0,
                 min_observations=32, stall_monitor=None,
                 min_inflight=MIN_INFLIGHT):
        self._registry = registry
        self._cost_model = cost_model
        self._interval_s = float(interval_s)
        self._min_observations = int(min_observations)
        self._stall_monitor = stall_monitor
        #: shrink floor for the in-flight bound.  Callers that know the
        #: pool size pass ``max(MIN_INFLIGHT, 2 * workers)``: under
        #: ack-on-delivery the bound counts UNDELIVERED positions, so
        #: shrinking below ~2x the pool on low-skew data would idle
        #: workers that FIFO's own default (2x workers) keeps busy.
        self._min_inflight = max(MIN_INFLIGHT, int(min_inflight))
        self._last_tune = 0.0
        self._last_observations = 0
        self._last_wait = self._last_step = 0.0
        #: ingest plane: wait/fetch counters snapshotted per
        #: window so each decision reads a DELTA, not lifetime totals.
        self._ingest_plane = None
        self._last_ingest_wait = self._last_ingest_fetches = 0.0
        if stall_monitor is not None:
            self._baseline_stall_monitor(stall_monitor)
        if registry is not None:
            self._g_window = registry.gauge('sched_window')
            self._g_inflight = registry.gauge('sched_max_inflight')
            self._g_prefetch = registry.gauge('sched_prefetch')
            self._g_ingest = registry.gauge('sched_ingest_window')
            self._c_adjust = registry.counter('sched_adjust_total')

    def attach_ingest(self, plane):
        """Give the autotuner the reader's ingest plane: its measured
        decode-blocked-on-fetch time is the window-sizing signal
        (``ingest_wait`` > 0 means the readahead is too shallow; fetches
        completing with zero waits mean it can shrink)."""
        self._ingest_plane = plane
        if plane is not None:
            self._last_ingest_wait = plane.wait_seconds
            self._last_ingest_fetches = plane.fetch_count

    def attach_stall_monitor(self, monitor):
        self._stall_monitor = monitor
        if monitor is not None:
            self._baseline_stall_monitor(monitor)

    def _baseline_stall_monitor(self, monitor):
        """Snapshot the monitor's counters so the first window is a
        DELTA — an attached monitor may carry lifetime totals (warmup
        stalls long resolved) that would otherwise drive the first
        prefetch decision."""
        self._last_wait = monitor.wait_time
        self._last_step = monitor.step_time

    def _window_wait_fraction(self):
        """StallMonitor delta since the last tune (None when absent or
        no new steps)."""
        monitor = self._stall_monitor
        if monitor is None:
            return None
        wait, step = monitor.wait_time, monitor.step_time
        d_wait = wait - self._last_wait
        d_step = step - self._last_step
        self._last_wait, self._last_step = wait, step
        total = d_wait + d_step
        return (d_wait / total) if total > 0 else None

    def maybe_tune(self, knobs, decode=None, host_batch=None,
                   device_put=None):
        now = time.monotonic()
        if now - self._last_tune < self._interval_s:
            return False
        if self._cost_model is not None:
            fresh = self._cost_model.observations - self._last_observations
            if fresh < self._min_observations:
                return False
            self._last_observations = self._cost_model.observations
        return self.tune(knobs, decode=decode, host_batch=host_batch,
                         device_put=device_put)

    def tune(self, knobs, decode=None, host_batch=None, device_put=None):
        """One decision pass (rate limiting handled by maybe_tune)."""
        now = time.monotonic()
        if now - self._last_tune < self._interval_s:
            return False
        self._last_tune = now

        skew = _hist_ratio(decode)
        if skew is None and self._cost_model is not None:
            # parent-side decode histograms are empty for process pools
            # (children observe into their own registries); the cost
            # model sees every ack regardless of pool type
            skew = self._cost_model.skew_ratio()
        skewed = skew is not None and skew >= SKEW_RATIO_FLOOR
        wait_frac = self._window_wait_fraction()
        starved = wait_frac is not None and wait_frac > 0.1
        hb_p99 = _q(host_batch, 0.99)
        dp_p99 = _q(device_put, 0.99)
        delivery_jitter = (hb_p99 is not None and dp_p99 is not None
                           and hb_p99 > 4.0 * dp_p99)

        changed = False
        skew_inputs = {'skew_ratio': skew, 'floor': SKEW_RATIO_FLOOR}
        if skewed:
            # reordering headroom exists: widen the window so slow
            # pieces can move earlier, deepen in-flight so the reorder
            # gap stays covered
            changed |= self._step_logged(knobs, 'window', 1.5,
                                         MIN_WINDOW, MAX_WINDOW,
                                         'grow', 'skew_ratio_floor',
                                         skew_inputs)
            changed |= self._step_logged(knobs, 'max_inflight', 1.25,
                                         self._min_inflight, MAX_INFLIGHT,
                                         'grow', 'skew_ratio_floor',
                                         skew_inputs)
        elif skew is not None:
            # MEASURED non-skew shrinks; no signal at all (skew None)
            # leaves the ordering knobs alone — stepping toward the
            # minimums on absence of evidence would throttle the exact
            # workloads that have not produced timings yet
            changed |= self._step_logged(knobs, 'window', 1 / 1.5,
                                         MIN_WINDOW, MAX_WINDOW,
                                         'shrink', 'skew_ratio_floor',
                                         skew_inputs)
            changed |= self._step_logged(knobs, 'max_inflight', 1 / 1.25,
                                         self._min_inflight, MAX_INFLIGHT,
                                         'shrink', 'skew_ratio_floor',
                                         skew_inputs)
        else:
            # The named no-evidence hold: the ordering knobs stay put
            # BECAUSE there is no timing signal — a first-class
            # suppressed non-action in the decision journal.
            _decisions.record_decision(
                'autotuner', 'hold', 'no_evidence_hold', skew_inputs,
                suppressed=True)
        # The prefetch knob moves only on a MEASURED signal, same rule
        # as the ordering knobs: a StallMonitor window when one is
        # attached, else populated host_batch AND device_put histograms
        # (host-only consumption has no device_put signal — halving a
        # user-set prefetch there would claw back overlap on zero
        # evidence).
        if wait_frac is not None:
            changed |= self._step_logged(
                knobs, 'prefetch', 2.0 if starved else 0.5,
                MIN_PREFETCH, MAX_PREFETCH,
                'grow' if starved else 'shrink', 'wait_frac_floor',
                {'wait_frac': wait_frac, 'floor': 0.1})
        elif hb_p99 is not None and dp_p99 is not None:
            changed |= self._step_logged(
                knobs, 'prefetch', 2.0 if delivery_jitter else 0.5,
                MIN_PREFETCH, MAX_PREFETCH,
                'grow' if delivery_jitter else 'shrink',
                'delivery_jitter',
                {'hb_p99': hb_p99, 'dp_p99': dp_p99, 'slow_factor': 4.0})
        # Ingest readahead window: decode measurably blocked
        # on an in-flight fetch this window -> deepen the readahead so
        # bytes land earlier; a window of fetches completing with zero
        # waits -> latency is fully hidden, shrink gently (buffer memory
        # back).  No fetches at all is no signal — leave it alone.
        if self._ingest_plane is not None:
            wait = self._ingest_plane.wait_seconds
            fetches = self._ingest_plane.fetch_count
            d_wait = wait - self._last_ingest_wait
            d_fetches = fetches - self._last_ingest_fetches
            self._last_ingest_wait = wait
            self._last_ingest_fetches = fetches
            ingest_inputs = {'d_wait_s': d_wait,
                             'grow_s': INGEST_WAIT_GROW_S,
                             'd_fetches': d_fetches}
            if d_wait > INGEST_WAIT_GROW_S:
                changed |= self._step_logged(
                    knobs, 'ingest_window', 1.5,
                    MIN_INGEST_WINDOW, MAX_INGEST_WINDOW,
                    'grow', 'ingest_wait_grow_s', ingest_inputs)
            elif d_fetches > 0:
                changed |= self._step_logged(
                    knobs, 'ingest_window', 1 / 1.25,
                    MIN_INGEST_WINDOW, MAX_INGEST_WINDOW,
                    'shrink', 'ingest_wait_grow_s', ingest_inputs)
        if self._registry is not None:
            self._g_window.set(knobs.window)
            self._g_inflight.set(knobs.max_inflight)
            self._g_prefetch.set(knobs.prefetch)
            if self._ingest_plane is not None:
                self._g_ingest.set(knobs.ingest_window)
            if changed:
                self._c_adjust.inc()
        return changed

    @staticmethod
    def _step(knobs, name, factor, lo, hi):
        current = getattr(knobs, name)
        target = min(hi, max(lo, int(round(current * factor))))
        if target == current:
            return False
        knobs.apply(name, target)
        return True

    def _step_logged(self, knobs, name, factor, lo, hi, action, rule,
                     inputs):
        """:meth:`_step` + a decision record when the knob actually
        moved — the record carries the clamp arithmetic inputs so the
        determinism cross-check can re-derive the new value."""
        current = getattr(knobs, name)
        changed = self._step(knobs, name, factor, lo, hi)
        if changed:
            _decisions.record_decision(
                'autotuner', action, rule,
                dict(inputs, current=current, factor=factor,
                     lo=lo, hi=hi),
                knob=name, new=getattr(knobs, name))
        return changed


def _q(hist, q):
    if hist is None or not getattr(hist, 'count', 0):
        return None
    return hist.quantile(q)


def _hist_ratio(hist):
    """p99/p50 of a registry histogram, or None without signal."""
    if hist is None or getattr(hist, 'count', 0) < 8:
        return None
    p50, p99 = hist.quantile(0.5), hist.quantile(0.99)
    if not p50:
        return None
    return p99 / p50


def piece_weights(items, pieces):
    """Seed weights for :meth:`PieceCostModel.seed` from the reader's
    work items and global piece list: per-piece row counts (the size
    proxy the footer metadata always carries; -1 = unknown is
    skipped)."""
    weights = {}
    for item in items:
        try:
            idx = item[0]
        except (TypeError, IndexError, KeyError):
            continue
        if not isinstance(idx, int) or not 0 <= idx < len(pieces):
            continue
        num_rows = getattr(pieces[idx], 'num_rows', -1)
        if num_rows and num_rows > 0:
            weights[idx] = num_rows
    return weights
