"""The fleet's closed-loop autoscaler.

Counterpart of ``petastorm_tpu/service/autoscaler.py``, its control law as
written there.  A tick controller inside the dispatcher (``maybe_tick()``
from the serve loop; no thread of its own) computes what the fleet needs and
acts through a :class:`WorkerLauncher`:

* **scale out** when pending splits have starved for ``autoscale_starve_s``:
  no live worker has a free lease slot (or none lives) while work waits;
* **scale in** when the fleet has been idle (nothing pending, nothing
  leased) for ``autoscale_idle_s`` with more than ``autoscale_min_workers``
  alive: through the graceful drain, of the worker whose departure costs the
  least cache-directory coverage;
* **damping**: a cooldown after any action, at most ``autoscale_step``
  workers an action, the live count held in ``[autoscale_min_workers,
  autoscale_max_workers]``.

Each action and each suppression is a record of the decision journal.  Kill
switch: ``PETASTORM_TPU_NO_AUTOSCALE=1`` beats any config; the controller
is built and never acts.  Loads neither torch nor JAX.
"""

import logging
import os
import subprocess
import sys
import time

from petastorm_tpu_torch.telemetry import decisions as _decisions

logger = logging.getLogger(__name__)

__all__ = ['KILL_SWITCH', 'killed', 'WorkerLauncher', 'SubprocessWorkerLauncher', 'Autoscaler']

KILL_SWITCH = 'PETASTORM_TPU_NO_AUTOSCALE'


def killed():
    """True when the environment vetoes autoscaling on this host."""
    return os.environ.get(KILL_SWITCH, '') not in ('', '0')


class WorkerLauncher(object):
    """The seam between the control law and worker processes: a scale-out
    calls ``spawn(dispatcher_addr)``; a scale-in is the dispatcher's own
    drain, reported by ``notify_drain(worker_id)``."""

    def spawn(self, dispatcher_addr):
        raise NotImplementedError

    def notify_drain(self, worker_id):
        """A drain of ``worker_id`` began (informational)."""

    def close(self):
        """Release what the launcher holds (the children it still owns)."""


class SubprocessWorkerLauncher(WorkerLauncher):
    """Decode workers as child processes of the dispatcher's process, started
    as an operator would: ``python -m petastorm_tpu_torch.service.cli worker
    --dispatcher ADDR`` (with the SIGTERM drain), the package's root put
    first on ``PYTHONPATH``.  ``worker_args`` go after; ``env`` is laid over
    the environment."""

    def __init__(self, worker_args=None, env=None):
        self._worker_args = list(worker_args or ())
        self._env = dict(env or {})
        self._procs = []

    @property
    def procs(self):
        """The children started, in order."""
        return list(self._procs)

    def spawn(self, dispatcher_addr):
        cmd = [sys.executable, '-m', 'petastorm_tpu_torch.service.cli', 'worker', '--dispatcher',
               dispatcher_addr] + self._worker_args
        # ``-m`` resolves from the child's cwd: the package's root first makes
        # a dispatcher started anywhere spawn importable workers
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, **self._env)
        env['PYTHONPATH'] = root + (os.pathsep + env['PYTHONPATH']
                                    if env.get('PYTHONPATH') else '')
        proc = subprocess.Popen(cmd, env=env)
        self._procs.append(proc)
        logger.info('autoscaler spawned worker pid %d', proc.pid)
        return proc.pid

    def close(self):
        for proc in self._procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 10.0
        for proc in self._procs:
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5.0)
        self._procs = []


class Autoscaler(object):
    """The tick controller.  The dispatcher's thread owns and calls it, so
    it holds no lock."""

    #: Seconds between observations (the serve loop turns every ~100 ms;
    #: control under a second would chase noise).
    TICK_S = 1.0

    def __init__(self, config, launcher, now=None):
        self.config = config
        self.launcher = launcher
        self.enabled = bool(config.autoscale) and not killed()
        now = time.monotonic() if now is None else now
        self._next_tick = now
        self._cooldown_until = 0.0
        self._starve_since = None
        self._idle_since = None
        #: actions, and urges the cooldown or the bounds vetoed
        self.scale_outs = 0
        self.scale_ins = 0
        self.suppressed = 0
        self.last_action = None
        self.last_action_t = None
        #: the journal it records in (the dispatcher's); None: the process's
        self.decisions = None

    @property
    def actions(self):
        return self.scale_outs + self.scale_ins

    def maybe_tick(self, observation, now=None):
        """One evaluation of the control law; returns the action taken.

        ``observation`` is the dispatcher's view under its lock::

            {'pending': int, 'leased': int,
             'alive': [worker_id, ...],        # not draining, heartbeat fresh
             'free_slots': int,                # lease slots free on them
             'coverage': {worker_id: int},     # cache digests each holds
             'dispatcher_addr': str}

        Returns None, ``('scale_out', n)`` after spawning ``n`` workers, or
        ``('scale_in', worker_id)`` naming the worker the dispatcher drains.
        """
        now = time.monotonic() if now is None else now
        if not self.enabled or now < self._next_tick:
            return None
        self._next_tick = now + self.TICK_S
        pending = int(observation.get('pending', 0))
        leased = int(observation.get('leased', 0))
        alive = list(observation.get('alive') or ())
        free_slots = int(observation.get('free_slots', 0))

        starved = pending > 0 and (not alive or free_slots == 0)
        idle = pending == 0 and leased == 0 and alive
        # None checks: a clock of 0.0 is set
        if starved:
            if self._starve_since is None:
                self._starve_since = now
        else:
            self._starve_since = None
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        cfg = self.config
        cooldown_left = max(0.0, self._cooldown_until - now)
        if starved and now - self._starve_since >= cfg.autoscale_starve_s:
            want = min(cfg.autoscale_step, cfg.autoscale_max_workers - len(alive))
            inputs = {'pending': pending, 'leased': leased, 'alive': alive,
                      'free_slots': free_slots,
                      'starve_s': round(now - self._starve_since, 3),
                      'threshold_s': cfg.autoscale_starve_s,
                      'step': cfg.autoscale_step,
                      'max_workers': cfg.autoscale_max_workers,
                      'cooldown_remaining_s': round(cooldown_left, 3)}
            if want <= 0 or now < self._cooldown_until:
                self.suppressed += 1
                _decisions.record_decision(
                    'autoscaler', 'hold', 'autoscale_cooldown_s',
                    dict(inputs, want=want, wanted='scale_out'), suppressed=True,
                    cooldown_until=self._cooldown_until, journal=self.decisions)
                return None
            spawned = 0
            for _ in range(want):
                try:
                    self.launcher.spawn(observation['dispatcher_addr'])
                    spawned += 1
                except Exception:  # noqa: BLE001 — the starvation stays, the next tick retries
                    logger.exception('autoscaler spawn failed')
                    break
            if not spawned:
                return None
            self.scale_outs += 1
            self._after_action('scale_out', now)
            self._starve_since = None
            _decisions.record_decision(
                'autoscaler', 'scale_out', 'autoscale_starve_s', inputs,
                cooldown_until=self._cooldown_until, spawned=spawned, journal=self.decisions)
            return ('scale_out', spawned)

        if idle and now - self._idle_since >= cfg.autoscale_idle_s \
                and len(alive) > cfg.autoscale_min_workers:
            coverage = dict(observation.get('coverage') or {})
            inputs = {'pending': pending, 'leased': leased, 'alive': alive,
                      'idle_s': round(now - self._idle_since, 3),
                      'threshold_s': cfg.autoscale_idle_s,
                      'min_workers': cfg.autoscale_min_workers,
                      'coverage': coverage,
                      'cooldown_remaining_s': round(cooldown_left, 3)}
            if now < self._cooldown_until:
                self.suppressed += 1
                _decisions.record_decision(
                    'autoscaler', 'hold', 'autoscale_cooldown_s',
                    dict(inputs, want=1, wanted='scale_in'), suppressed=True,
                    cooldown_until=self._cooldown_until, journal=self.decisions)
                return None
            victim = self._drain_victim(alive, coverage)
            self.scale_ins += 1
            self._after_action('scale_in', now)
            self._idle_since = None
            _decisions.record_decision(
                'autoscaler', 'scale_in', 'autoscale_idle_s', inputs,
                cooldown_until=self._cooldown_until, worker_id=victim, journal=self.decisions)
            self.launcher.notify_drain(victim)
            return ('scale_in', victim)
        return None

    def _after_action(self, action, now):
        self.last_action = action
        self.last_action_t = now
        self._cooldown_until = now + self.config.autoscale_cooldown_s

    @staticmethod
    def _drain_victim(alive, coverage):
        """The live worker holding the fewest cache digests (ties by id)."""
        coverage = coverage or {}
        return min(alive, key=lambda wid: (coverage.get(wid, 0), wid))

    def snapshot(self):
        """The counters of the dispatcher's ``stats``."""
        return {'enabled': self.enabled,
                'killed': killed(),
                'scale_outs': self.scale_outs,
                'scale_ins': self.scale_ins,
                'actions': self.actions,
                'suppressed': self.suppressed,
                'last_action': self.last_action}

    def close(self):
        try:
            self.launcher.close()
        except Exception:  # noqa: BLE001 — a shutdown does not raise
            logger.exception('autoscaler launcher close failed')
