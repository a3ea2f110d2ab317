"""The port's train-state checkpoints (``petastorm_tpu_torch.checkpoint``):
the cases of ``tests/test_orbax_checkpoint.py`` that do not concern orbax
itself, with ``torch.save`` for the model state and a pickled data state.

The manager's cadence is the reference manager's (the JAX package's,
through orbax), held against it on the same calls; retention, asynchronous
saves, ``restore_latest`` and the reserved keys as there; and a real
loader token rides a checkpoint and resumes the stream exactly.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from petastorm_tpu.checkpoint import TrainStateManager as JaxTrainStateManager

from petastorm_tpu_torch import checkpoint
from petastorm_tpu_torch.checkpoint import TrainStateManager
from petastorm_tpu_torch.gpu import DataLoader, DeviceInMemDataLoader

from torch_plane_common import ROWS, port_reader, to_numpy, write_dataset


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_ckpt'))


def test_save_restore_train_state(tmp_path, url):
    """Model state and an exact loader snapshot in one call; the restored
    token resumes the stream: every row exactly once."""
    params = {'w': torch.full((3,), 2.0), 'step': torch.tensor(7)}
    reader = port_reader(url, False, shuffle_row_groups=True, seed=5)
    with DataLoader(reader, 6, prefetch=1, device='cpu', drop_last=False) as loader:
        it = iter(loader)
        seen = to_numpy(next(it))['id'].tolist()
        checkpoint.save_train_state(tmp_path / 'ck', params, data_state=loader.state_dict())
    assert sorted(os.listdir(tmp_path)) == ['ck']   # published by one rename
    model, data_state = checkpoint.restore_train_state(tmp_path / 'ck')
    assert torch.equal(model['w'], params['w']) and int(model['step']) == 7
    reader = port_reader(url, False, shuffle_row_groups=True, seed=5,
                         resume_state=data_state['reader'])
    with DataLoader(reader, 6, prefetch=1, device='cpu', drop_last=False,
                    resume_state=data_state) as resumed:
        for batch in resumed:
            seen.extend(to_numpy(batch)['id'].tolist())
    assert sorted(seen) == list(range(ROWS))


def test_without_data_state_and_structures(tmp_path):
    checkpoint.save_train_state(tmp_path / 'a', {'a': torch.arange(4)})
    model, data_state = checkpoint.restore_train_state(tmp_path / 'a')
    assert torch.equal(model['a'], torch.arange(4)) and data_state is None
    # a dict that uses the key 'model' stays a dict
    checkpoint.save_train_state(tmp_path / 'b', {'model': {'w': torch.ones(2)}})
    model, _ = checkpoint.restore_train_state(tmp_path / 'b')
    assert set(model) == {'model'} and torch.equal(model['model']['w'], torch.ones(2))
    # a structure that is not a dict comes back as itself
    checkpoint.save_train_state(tmp_path / 'c', [torch.zeros(3), torch.ones(2)])
    model, _ = checkpoint.restore_train_state(tmp_path / 'c')
    assert isinstance(model, list) and len(model) == 2
    with pytest.raises(FileExistsError):
        checkpoint.save_train_state(tmp_path / 'c', [torch.zeros(1)])


def test_reserved_keys_raise(tmp_path):
    for key in ('petastorm_tpu_data_state', 'petastorm_tpu_wrapped_model'):
        with pytest.raises(ValueError, match='reserved'):
            checkpoint.save_train_state(tmp_path / key, {key: torch.zeros(1)})


def test_the_model_file_loads_weights_only(tmp_path):
    """The model file reads with ``weights_only=True``; numpy arrays and
    generator states belong to the data state, which pickle reads."""
    state = {'rng': np.random.default_rng(3).bit_generator.state, 'a': np.arange(3)}
    checkpoint.save_train_state(tmp_path / 'w', {'t': torch.ones(2)}, data_state=state)
    payload = torch.load(tmp_path / 'w' / 'model.pt', weights_only=True)
    assert torch.equal(payload['t'], torch.ones(2))
    with open(tmp_path / 'w' / 'data_state.pkl', 'rb') as f:
        data = pickle.load(f)
    assert data['rng'] == state['rng'] and np.array_equal(data['a'], state['a'])


def test_cadence_retention_resume(tmp_path):
    ckdir = tmp_path / 'mgr'
    with TrainStateManager(ckdir, save_interval_steps=2, max_to_keep=2) as mgr:
        for step in range(7):
            mgr.save(step, {'w': torch.full((3,), float(step))},
                     data_state={'cursor': step, 'epoch': step // 4})
        mgr.wait_until_finished()
        assert mgr.all_steps() == [4, 6]   # cadence 2, the last 2 kept
    assert sorted(os.listdir(ckdir)) == ['4', '6']
    step, model, data = TrainStateManager.restore_latest_from(ckdir)
    assert step == 6 and torch.equal(model['w'], torch.full((3,), 6.0))
    assert data == {'cursor': 6, 'epoch': 1}


@pytest.mark.parametrize('interval', [1, 3, 100])
def test_should_save_follows_the_reference_manager(tmp_path, interval):
    """The same calls give the same decisions as the JAX package's manager
    (orbax underneath): the first step always, then the cadence, and never
    a step at or before the latest save."""
    port = TrainStateManager(tmp_path / 'port', save_interval_steps=interval, max_to_keep=2)
    ref = JaxTrainStateManager(tmp_path / 'ref', save_interval_steps=interval, max_to_keep=2,
                               async_save=False)
    try:
        decisions = []
        for step in (5, 5, 6, 7, 9, 12, 12, 300, 299, 301):
            want = ref.should_save(step)
            decisions.append(want)
            assert port.should_save(step) == want, step
            if want:
                ref.save(step, {'w': np.zeros(1)})
                port.save(step, {'w': torch.zeros(1)})
                port.wait_until_finished()
        assert any(decisions) and not all(decisions)
        assert port.all_steps() == [int(s) for s in ref.all_steps()]
    finally:
        port.close()
        ref.close()


def test_empty_directory(tmp_path):
    assert TrainStateManager.restore_latest_from(tmp_path / 'none') == (None, None, None)


def test_force_and_a_loader_token(tmp_path, url):
    """force=True saves off-cadence; a real token resumes the stream exactly."""
    def build(resume=None):
        reader = port_reader(url, False, num_epochs=1, resume_state=(resume or {}).get('reader'))
        return DataLoader(reader, 5, resume_state=resume, device='cpu')

    with build() as loader:
        full = [to_numpy(b)['id'].tolist() for b in loader]
    with TrainStateManager(tmp_path / 'mgr', save_interval_steps=1000, async_save=False) as mgr:
        assert mgr.save(0, {'w': torch.zeros(2)})        # nothing saved yet: the cadence takes it
        assert not mgr.save(7, {'w': torch.zeros(2)})    # off-cadence
        with build() as loader:
            it = iter(loader)
            first = [to_numpy(next(it))['id'].tolist() for _ in range(2)]
            assert mgr.save(7, {'w': torch.zeros(2)}, data_state=loader.state_dict(),
                            force=True)
    step, _, token = TrainStateManager.restore_latest_from(tmp_path / 'mgr')
    assert step == 7
    with build(resume=token) as loader2:
        assert first + [to_numpy(b)['id'].tolist() for b in loader2] == full


def test_async_save_copies_at_save_time(tmp_path):
    """An asynchronous save holds the values of the moment it was called:
    the tensors are copied to the host before ``save`` returns."""
    w = torch.zeros(1000)
    with TrainStateManager(tmp_path / 'mgr', save_interval_steps=1) as mgr:
        for step in range(3):
            w.fill_(step)
            mgr.save(step, {'w': w}, data_state={'step': step})
            w.fill_(-1.0)
        mgr.wait_until_finished()
        for step in mgr.all_steps():
            model, data = mgr.restore(step)
            assert torch.equal(model['w'], torch.full((1000,), float(step)))
            assert data == {'step': step}


def test_a_write_error_raises_at_the_next_wait(tmp_path):
    target = tmp_path / 'mgr'
    with TrainStateManager(target, save_interval_steps=1) as mgr:
        os.makedirs(target / '0')   # the step's directory exists already
        mgr.save(0, {'w': torch.zeros(1)})
        with pytest.raises(FileExistsError):
            mgr.wait_until_finished()


def test_device_inmem_mid_epoch_token(tmp_path, url):
    """The HBM loader's mid-epoch token (content-sorted cache) rides the
    manager and resumes the stream exactly."""
    def build(resume=None):
        reader = port_reader(url, False, num_epochs=1)
        return DeviceInMemDataLoader(reader, 8, num_epochs=3, seed=5,
                                     deterministic_cache_order=True, resume_state=resume,
                                     device='cpu')

    with build() as loader:
        full = [b['id'].tolist() for b in loader]
    cut = 10   # 8 steps per epoch: 2 into epoch 1
    with build() as loader:
        it = iter(loader)
        consumed = [next(it)['id'].tolist() for _ in range(cut)]
        with TrainStateManager(tmp_path / 'dim', save_interval_steps=1, max_to_keep=1) as mgr:
            assert mgr.save(cut, {'w': torch.ones(2)}, data_state=loader.state_dict())
    step, _, token = TrainStateManager.restore_latest_from(tmp_path / 'dim')
    assert step == cut and token['device_inmem']['steps_into_epoch'] == 2
    with build(resume=token) as loader2:
        assert consumed + [b['id'].tolist() for b in loader2] == full
