"""The step graphs' plumbing (``petastorm_tpu_torch.gpu.graphs``) on the CPU.

A CUDA graph exists only on the card, where ``chip_smoke.py`` holds every
graphed path against its eager loop.  Here a fake stands in for the CUDA side
so that the plumbing around it runs: warm-up steps, static input slots, the
copy of each new input into them, one graph per input shape, the carry and
the device cursor of the scans, the token loop's counter, and the launch
counters.  The fake runs the
step at capture and skips the replay that follows it (a real capture runs
nothing and that replay runs the step; every caller replays right after
capturing), and each later replay runs the step again on the static slots
and copies its outputs into the static outputs.  The replayed loops must
give what the eager loops give, bit for bit.
"""

import importlib

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu import graphs
from petastorm_tpu_torch.gpu.loader import DataLoader, DeviceInMemDataLoader, PackedDataLoader
from petastorm_tpu_torch.models import decoding
from petastorm_tpu_torch.models.transformer import TransformerLM

fa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')


class _FakeGraph(object):
    def __init__(self, fn, args, outputs):
        self.fn, self.args, self.outputs = fn, args, outputs
        self.ran_at_capture = True
        self.replays = 0


class _FakeCuda(object):
    events = []

    @staticmethod
    def side_stream():
        return None

    @classmethod
    def run_on(cls, stream, fn, args):
        cls.events.append('warmup')
        return fn(*args)

    @classmethod
    def capture(cls, fn, args, stream, generators):
        cls.events.append('capture')
        out = fn(*args)
        return _FakeGraph(fn, args, out), out

    @classmethod
    def replay(cls, graph):
        cls.events.append('replay')
        graph.replays += 1
        if graph.ran_at_capture:
            graph.ran_at_capture = False
            return
        graphs.copy_into(graph.outputs, graph.fn(*graph.args))


@pytest.fixture
def fake_graphs(monkeypatch):
    """Graphs on the CPU through the fake; ``cuda_graph=False`` stays eager."""
    _FakeCuda.events = []
    monkeypatch.setattr(graphs, 'BACKEND', _FakeCuda)
    monkeypatch.setattr(graphs, 'resolve', lambda cuda_graph, device: cuda_graph is not False)
    return _FakeCuda.events


def test_a_graph_on_the_cpu_raises():
    assert graphs.resolve(None, 'cpu') is False
    assert graphs.resolve(False, 'cpu') is False
    with pytest.raises(ValueError, match='needs the card'):
        graphs.resolve(True, 'cpu')
    with pytest.raises(ValueError, match='needs the card'):
        graphs.resolve(True, torch.device('cpu'))
    model = TransformerLM(vocab_size=11, d_model=16, num_heads=2, num_layers=1, d_ff=32,
                          max_seq_len=16, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match='needs the card'):
        decoding.generate(model, torch.zeros(1, 3, dtype=torch.int64), 2, cuda_graph=True)


def test_graphed_step_replays_what_the_eager_loop_computes(fake_graphs):
    """One warm-up step, a capture on the second input (which still runs,
    by its replay), then replays on copies of each new input: the outputs
    and the state match the eager loop's, and outputs are the caller's."""
    def make():
        state = torch.zeros(3)

        def step(batch):
            state.mul_(0.5).add_(batch['x'])
            return state.sum() * batch['y']
        return state, step

    rng = np.random.default_rng(0)
    batches = [{'x': torch.tensor(rng.standard_normal(3), dtype=torch.float32),
                'y': torch.tensor(float(i + 1))} for i in range(6)]
    state, step = make()
    want = [step(b) for b in batches]
    state_g, step_g = make()
    graphed = graphs.StepGraph(step_g)
    got = [graphed(b) for b in batches]
    assert fake_graphs == ['warmup', 'capture'] + ['replay'] * 5
    assert torch.equal(torch.stack(got), torch.stack(want)) and torch.equal(state_g, state)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(got[1:], got[2:]))


@pytest.mark.parametrize('rows', [1, 4])
def test_a_replay_on_another_shape_raises(fake_graphs, rows):
    """A captured step replays only on inputs of its captured shape: a
    batch of fewer rows raises rather than being broadcast into the slot."""
    graphed = graphs.StepGraph(lambda batch: batch['x'].sum(0))
    for _ in range(2):
        graphed({'x': torch.ones(5, 3)})
    with pytest.raises(ValueError, match='captured shape'):
        graphed({'x': torch.ones(rows, 3)})
    assert graphs.signature({'x': torch.ones(5, 3)}) != graphs.signature({'x': torch.ones(rows, 3)})


def test_replays_count_the_launches_the_capture_recorded(fake_graphs, monkeypatch):
    """A capture adds nothing to the kernels' counters; each replay adds
    what the capture recorded (counters as the card's wrappers bump them)."""
    def step():
        fa.flash_fwd.launches += 2
        fa.flash_fwd.launches_by_design['cuda_core'] += 2
        fa.flash_bwd_dq.launches += 1
        fa.flash_bwd_dq.launches_by_design['tensor_core'] += 1

    assert all(k in graphs._COUNTED for k in fa.KERNELS)   # the wrappers register
    saved = [(k.launches, dict(k.launches_by_design)) for k in fa.KERNELS]
    try:
        for k in fa.KERNELS:
            k.launches, k.launches_by_design = 0, {'tensor_core': 0, 'cuda_core': 0}
        graph = graphs.StepGraph(step)
        graph.capture()
        assert [k.launches for k in fa.KERNELS] == [0, 0, 0]
        monkeypatch.setattr(_FakeCuda, 'replay', classmethod(lambda cls, g: None))  # counting only
        for _ in range(3):
            graph.replay()
        assert [k.launches for k in fa.KERNELS] == [6, 3, 0]
        assert fa.flash_fwd.launches_by_design == {'tensor_core': 0, 'cuda_core': 6}
        assert fa.flash_bwd_dq.launches_by_design == {'tensor_core': 3, 'cuda_core': 0}
    finally:
        for k, (n, by_design) in zip(fa.KERNELS, saved):
            k.launches, k.launches_by_design = n, by_design


@pytest.fixture(scope='module')
def docs_url(tmp_path_factory):
    from petastorm_tpu_torch import codecs, unischema
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    url = 'file://%s' % tmp_path_factory.mktemp('graph_docs')
    schema = unischema.Unischema('Docs', [
        unischema.UnischemaField('tokens', np.int32, (None,), codecs.NdarrayCodec(), False)])
    rng = np.random.default_rng(1)
    with DatasetWriter(url, schema, rows_per_rowgroup=8) as writer:
        for _ in range(40):
            writer.write({'tokens': rng.integers(1, 50, rng.integers(3, 20)).astype(np.int32)})
    return url


def _packed_scan(url, cuda_graph):
    from petastorm_tpu_torch.reader import make_reader

    weights = torch.linspace(0.5, 1.5, 20)
    acc = torch.zeros(())

    def step(carry, batch):
        acc.add_((batch['tokens'].float() * weights).sum())   # state outside the carry
        return carry * 0.9 + (batch['segment_ids'] > 0).sum(), acc * 1.0

    with make_reader(url, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        loader = PackedDataLoader(reader, 'tokens', max_len=20, rows_per_batch=2,
                                  drop_last=False, device='cpu')
        return [(c.clone(), o) for c, o in loader.scan_batches(
            step, torch.tensor(0.0), steps_per_call=5, cuda_graph=cuda_graph)]


def test_graphed_scan_batches_matches_eager(fake_graphs, docs_url):
    """The first full chunk warms up, the second is captured, later ones
    replay; the short tail chunk, a shape of its own, is its graph's warm-up;
    and every chunk's carry and outs equal the eager scan's."""
    want = _packed_scan(docs_url, cuda_graph=False)
    assert fake_graphs == []
    got = _packed_scan(docs_url, cuda_graph=None)
    assert len(got) == len(want) > 2 and want[-1][1].shape[0] < 5
    assert fake_graphs.count('warmup') == 2 and fake_graphs.count('capture') == 1
    assert fake_graphs.count('replay') == len(want) - 2
    for (c, o), (wc, wo) in zip(got, want):
        assert torch.equal(c, wc) and torch.equal(o, wo)


def _columnar_scan(rows, steps_per_call, cuda_graph):
    """``DataLoader.scan_batches`` over ``rows`` rows at batch 10 with
    ``drop_last=False``: the tail batch is ragged."""
    weights = torch.tensor([0.25, 2.0])
    state = torch.zeros(2)

    def step(carry, batch):
        state.add_(batch['x'].sum(0))   # state outside the carry
        return carry * 0.5 + (batch['x'] * weights).sum(), {'idx': batch['idx'].sum(),
                                                             's': state * 1.0}

    loader = DataLoader(_CacheReader(rows), 10, drop_last=False, device='cpu')
    return [(c.clone(), o) for c, o in loader.scan_batches(
        step, torch.tensor(0.0), steps_per_call=steps_per_call, cuda_graph=cuda_graph)]


@pytest.mark.parametrize('rows,steps_per_call,chunks', [
    (64, 1, [1] * 7),            # a 4-row tail after six full batches
    (61, 1, [1] * 7),            # a 1-row tail: it must not be broadcast to 10 rows
    (71, 3, [3, 3, 1, 1]),       # full batches % k == 1, then a 1-row tail
])
def test_graphed_columnar_scan_keeps_the_ragged_tail(fake_graphs, rows, steps_per_call,
                                                     chunks):
    """A chunk of a new shape (the ragged tail batch, the short chunk it
    flushes) gets a graph of its own, so every chunk's carry and outs equal
    the eager scan's."""
    want = _columnar_scan(rows, steps_per_call, cuda_graph=False)
    got = _columnar_scan(rows, steps_per_call, cuda_graph=None)
    assert [int(o['idx'].shape[0]) for _, o in want] == chunks
    assert int(want[-1][1]['idx'][-1]) == sum(range(rows - rows % 10, rows))
    assert len(got) == len(want)
    for (c, o), (wc, wo) in zip(got, want):
        assert torch.equal(c, wc)
        assert torch.equal(o['idx'], wo['idx']) and torch.equal(o['s'], wo['s'])


def test_a_graphed_scan_takes_a_carry_of_tensors(fake_graphs):
    """On the card the carry goes into static slots, so a Python number in
    it raises (the eager loop takes it)."""
    loader = DataLoader(_CacheReader(20), 10, device='cpu')
    step = lambda carry, batch: (carry + 1, batch['x'].sum())
    assert [c for c, _ in loader.scan_batches(step, 0, steps_per_call=1,
                                              cuda_graph=False)] == [1, 2]
    with pytest.raises(TypeError, match='takes tensors'):
        list(loader.scan_batches(step, 0, steps_per_call=1))


class _CacheReader(object):
    """A columnar reader of one epoch for the in-memory loaders."""
    batched_output = True
    num_epochs = 1

    def __init__(self, n):
        rng = np.random.default_rng(3)
        self._chunk = {'idx': np.arange(n, dtype=np.int64),
                       'x': rng.standard_normal((n, 2)).astype(np.float32)}

    def __iter__(self):
        yield dict(self._chunk)

    def stop(self):
        pass

    def join(self):
        pass


@pytest.mark.parametrize('epochs_per_call', [1, 2])
def test_graphed_scan_epochs_matches_eager(fake_graphs, epochs_per_call):
    """The device cursor gathers each batch of the epoch's order, the step's
    out lands at the cursor of the [steps] buffer, the carry threads through:
    five epochs equal the eager scan's, with one warm-up and one capture."""
    def run(cuda_graph):
        state = torch.zeros(2)

        def step(carry, batch):
            state.add_(batch['x'].sum(0))
            return carry + batch['idx'].sum(), {'idx': batch['idx'], 's': state * 1.0}

        loader = DeviceInMemDataLoader(_CacheReader(23), 5, num_epochs=5, seed=9,
                                       device='cpu')
        return [(c.clone(), o) for c, o in loader.scan_epochs(
            step, torch.tensor(0), epochs_per_call=epochs_per_call, cuda_graph=cuda_graph)]

    want = run(False)
    got = run(None)
    assert fake_graphs.count('warmup') == 1 and fake_graphs.count('capture') == 1
    assert fake_graphs.count('replay') == 5 * 4 - 1
    assert len(got) == len(want)
    for (c, o), (wc, wo) in zip(got, want):
        assert torch.equal(c, wc)
        assert torch.equal(o['idx'], wo['idx']) and torch.equal(o['s'], wo['s'])


@pytest.mark.parametrize('knobs', [dict(), dict(temperature=0.9, top_p=0.9),
                                   dict(temperature=1.2, top_k=4, eos_id=5, pad_id=0)])
def test_graphed_generate_matches_eager(fake_graphs, knobs):
    """One token step warmed up, captured, and replayed with the device step
    counter and the cache's device position: the tokens of the eager loop."""
    model = TransformerLM(vocab_size=13, d_model=16, num_heads=2, num_layers=2, d_ff=32,
                          max_seq_len=24, compute_dtype=torch.float32, pos_embed='rope',
                          num_kv_heads=1, generator=torch.Generator().manual_seed(2))
    prompt = torch.tensor(np.random.default_rng(4).integers(0, 13, (2, 5)))
    rng = prng.PRNGKey(7) if knobs else None
    want = decoding.generate(model, prompt, 9, rng=rng, cuda_graph=False, **knobs)
    got = decoding.generate(model, prompt, 9, rng=rng, **knobs)
    assert fake_graphs == ['warmup', 'capture'] + ['replay'] * 7
    assert torch.equal(got, want)


def test_a_capture_parks_every_live_transfer_thread(fake_graphs, monkeypatch):
    """A loader's transfer thread pins, copies and waits on events: a CUDA
    call of another thread can fail a capture, so the thread is parked for
    the capture (it pulls nothing while the consumer drains its queue) and
    resumes after it; the cyclic garbage collector, which could destroy an
    unreachable graph inside the capture, is held off for it."""
    import gc
    import itertools
    import time
    from petastorm_tpu_torch.gpu import transfer

    pulled = []

    def source():
        for i in itertools.count():
            pulled.append(i)
            yield i

    pump = transfer.DispatchPump(source(), lambda x: x, prefetch=2).start()
    seen = {}
    fake_capture = _FakeCuda.capture

    def capture(fn, args, stream, generators):
        before = len(pulled)
        drained = [pump.get() for _ in range(len(pump.pending))]
        time.sleep(0.05)
        seen.update(paused=pump._pause, frozen=len(pulled) == before, drained=drained,
                    collector=gc.isenabled())
        return fake_capture(fn, args, stream, generators)

    monkeypatch.setattr(_FakeCuda, 'capture', staticmethod(capture))
    try:
        graphed = graphs.StepGraph(lambda x: x * 2)
        assert pump.get() == 0
        for _ in range(3):
            graphed(torch.ones(2))
        assert seen['paused'] == 1 and seen['frozen'] and seen['drained']
        # the cyclic collector is held off through the capture, and back after it
        assert seen['collector'] is False and gc.isenabled()
        assert fake_graphs == ['warmup', 'capture', 'replay', 'replay']
        assert pump._pause == 0
        assert pump.get() == seen['drained'][-1] + 1   # resumed in order
    finally:
        pump.stop()
    assert not pump.alive


def test_graphed_steps_on_the_pumped_loader_match_eager(fake_graphs):
    """A step graph fed by the pumped loader (its transfer thread live
    through the warm-up, the capture and the replays) computes what the
    eager step computes on the inline loader's batches."""
    def run(cuda_graph, transfer):
        state = torch.zeros(2)

        def step(batch):
            state.mul_(0.5).add_(batch['x'].sum(0))
            return state.sum() + batch['idx'].sum()

        fn = graphs.StepGraph(step) if cuda_graph is not False else step
        with DataLoader(_CacheReader(64), 8, transfer=transfer, device='cpu') as loader:
            outs = [fn(batch) for batch in loader]
            pump = loader._pump
        assert (pump is not None) == transfer and not (pump and pump.alive)
        return torch.stack(outs), state

    want, want_state = run(False, False)
    got, got_state = run(None, True)
    assert fake_graphs == ['warmup', 'capture'] + ['replay'] * 7
    assert torch.equal(got, want) and torch.equal(got_state, want_state)
