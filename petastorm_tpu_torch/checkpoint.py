"""Train-state checkpoints: the model's state and the data plane's token.

Counterpart of ``petastorm_tpu/checkpoint.py`` without orbax.  A
checkpoint is a directory of two files: ``model.pt``, the model (and
optimizer) state through ``torch.save``, read back with
``torch.load(weights_only=True)``; and ``data_state.pkl``, the data plane's
token (``Reader.state_dict``, a loader's ``state_dict``, or any picklable
structure of them: numpy arrays and ``bit_generator`` states, which the
weights-only loader refuses) as one pickled blob::

    from petastorm_tpu_torch import checkpoint

    checkpoint.save_train_state(path, {'model': model.state_dict(),
                                       'opt': opt.state_dict()},
                                data_state=loader.state_dict())
    ...
    model_state, data_state = checkpoint.restore_train_state(path)
    reader = make_reader(url, ..., resume_state=data_state['reader'])
    loader = DataLoader(reader, batch_size, resume_state=data_state)

A directory is written under a temporary name and published with one
rename: a checkpoint either exists whole or not at all.  The model state
is a tree of tensors, dicts, lists, tuples and Python scalars (what the
weights-only loader reads); tensors come back on the CPU.

:class:`TrainStateManager` keeps one such directory per step, named by the
step, under a root: the save cadence, retention, asynchronous saves and
resume-latest of the reference's manager.

Multi-host: tokens are per host.  Each host saves its own ``data_state``
under a directory of its own, ``f'{path}/host_{rank}'`` with ``rank`` the
``torch.distributed`` rank (the readers shard by it), or gathers every
host's token first and saves the list from rank 0.  After a restart on
another number of hosts, read each old host's token back with
:meth:`TrainStateManager.restore_latest_from` and pass the list to
:func:`petastorm_tpu_torch.elastic.reshard_loader_states`, which gives each
new host its loader token::

    tokens = [TrainStateManager.restore_latest_from('%s/host_%d' % (path, h))[2]
              for h in range(old_hosts)]
    token = reshard_loader_states(tokens, world)[rank]
    reader = make_reader(url, cur_shard=rank, shard_count=world,
                         resume_state=token['reader'])
    loader = DataLoader(reader, batch_size, resume_state=token)
"""

import io
import os
import pickle
import shutil
import threading
import uuid

import torch

__all__ = ['save_train_state', 'restore_train_state', 'TrainStateManager']

_DATA_KEY = 'petastorm_tpu_data_state'
_WRAP_KEY = 'petastorm_tpu_wrapped_model'
_MODEL_FILE = 'model.pt'
_DATA_FILE = 'data_state.pkl'


def save_train_state(path, model_state, data_state=None):
    """Write ``model_state`` and ``data_state`` (None: no data file) as a
    checkpoint directory at ``path``, which must not exist yet."""
    _publish(str(path), *_snapshot(model_state, data_state))


def restore_train_state(path):
    """``(model_state, data_state)`` of the checkpoint at ``path``;
    ``data_state`` is None when it was saved without one, and
    ``model_state`` has the structure it was saved with."""
    path = str(path)
    payload = torch.load(os.path.join(path, _MODEL_FILE), map_location='cpu',
                         weights_only=True)
    data_state = None
    data_path = os.path.join(path, _DATA_FILE)
    if os.path.exists(data_path):
        with open(data_path, 'rb') as f:
            data_state = pickle.load(f)   # written by this module's save
    if set(payload) == {_WRAP_KEY}:
        return payload[_WRAP_KEY], data_state
    return payload, data_state


def _snapshot(model_state, data_state):
    """What a save writes, taken now: the model state with every tensor
    copied to the host (so that training may go on changing the original)
    and the data state pickled."""
    if isinstance(model_state, dict):
        clash = {_DATA_KEY, _WRAP_KEY} & set(model_state)
        if clash:
            raise ValueError('model_state uses reserved key(s) %s' % sorted(clash))
        payload = model_state
    else:
        payload = {_WRAP_KEY: model_state}
    payload = _host_copy(payload)
    blob = None if data_state is None else pickle.dumps(data_state, protocol=4)
    return payload, blob


def _host_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, _host_copy(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _publish(path, payload, blob):
    """Write the two files under a temporary name beside ``path``, then
    rename it to ``path``."""
    if os.path.exists(path):
        raise FileExistsError('checkpoint %s exists already' % path)
    parent, name = os.path.split(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, '.%s.tmp-%s' % (name, uuid.uuid4().hex[:8]))
    os.makedirs(tmp)
    try:
        buf = io.BytesIO()
        torch.save(payload, buf)
        _write(os.path.join(tmp, _MODEL_FILE), buf.getvalue())
        if blob is not None:
            _write(os.path.join(tmp, _DATA_FILE), blob)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write(path, data):
    with open(path, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class TrainStateManager(object):
    """Periodic train-state checkpoints under ``directory``, one
    subdirectory per step::

        mgr = TrainStateManager(path, save_interval_steps=500, max_to_keep=3)
        for step, batch in enumerate(loader):
            ...
            if mgr.should_save(step):
                mgr.save(step, {'model': model.state_dict(), 'opt': opt.state_dict()},
                         data_state=loader.state_dict())
        mgr.wait_until_finished()

        step, model_state, data_state = TrainStateManager.restore_latest_from(path)

    :meth:`should_save` follows the reference manager's cadence: a step
    after the latest saved one that is a multiple of
    ``save_interval_steps``, or any step while nothing is saved yet.
    ``max_to_keep`` newest steps are kept (None: all).  With ``async_save``
    (the default) :meth:`save` copies the tensors to the host and pickles
    the data state before it returns, then writes on a thread of its own,
    one save at a time; an error of that thread is raised by the next
    :meth:`save` or :meth:`wait_until_finished`.
    """

    def __init__(self, directory, save_interval_steps=1, max_to_keep=3, async_save=True):
        if save_interval_steps < 1:
            raise ValueError('save_interval_steps must be >= 1')
        self._dir = str(directory)
        self._interval = int(save_interval_steps)
        self._keep = max_to_keep
        self._async = async_save
        self._thread = None
        self._error = None
        self._steps = self._steps_on_disk()

    def _steps_on_disk(self):
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit() and os.path.isdir(os.path.join(self._dir, name)))

    def _path(self, step):
        return os.path.join(self._dir, str(int(step)))

    def should_save(self, step):
        """True when the cadence persists ``step``: gate the loader's
        ``state_dict()`` (a drain of the reader) on this."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return not self._steps or step % self._interval == 0

    def save(self, step, model_state, data_state=None, force=False):
        """Persist ``(model_state, data_state)`` at ``step`` when the cadence
        says so, or always with ``force=True``; returns whether it saved."""
        if not force and not self.should_save(step):
            return False
        step = int(step)
        payload, blob = _snapshot(model_state, data_state)
        self.wait_until_finished()
        self._steps = sorted(set(self._steps) | {step})
        dropped = []
        if self._keep is not None and len(self._steps) > self._keep:
            dropped, self._steps = self._steps[:-self._keep], self._steps[-self._keep:]

        def write():
            _publish(self._path(step), payload, blob)
            for old in dropped:
                shutil.rmtree(self._path(old), ignore_errors=True)

        if not self._async:
            write()
            return True

        def run():
            try:
                write()
            except BaseException as e:  # noqa: BLE001 — raised by wait_until_finished
                self._error = e
        self._thread = threading.Thread(target=run, name='petastorm-tpu-torch-checkpoint',
                                        daemon=True)
        self._thread.start()
        return True

    def restore(self, step):
        """``(model_state, data_state)`` of a kept step."""
        self.wait_until_finished()
        return restore_train_state(self._path(step))

    def restore_latest(self):
        """``(step, model_state, data_state)``, or ``(None, None, None)``
        when the directory holds no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None, None, None
        model_state, data_state = self.restore(step)
        return step, model_state, data_state

    @classmethod
    def restore_latest_from(cls, directory):
        """Open, restore the latest step, close."""
        with cls(directory) as mgr:
            return mgr.restore_latest()

    def all_steps(self):
        return list(self._steps)

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def wait_until_finished(self):
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self):
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.close()
