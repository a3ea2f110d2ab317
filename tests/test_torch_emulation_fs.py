"""The port's cold-store emulation (``petastorm_tpu_torch.test_util.
emulation.BandwidthLimitedFilesystem``) against the JAX package's, on the CPU.

As ``tests/test_emulation_fs.py``, with the sleeps intercepted (both
modules' ``time.sleep``), so every case is instant: the same reads give the
same bytes and the same sleeps in both (one per 256 KiB chunk, summing to
bytes/bps; a bounded read pays its bytes only; the cold latency once per
handle of a file at or above the threshold, never for a small file nor with
no latency, when the size is not even asked); write handles pass through;
the wrapper pickles and delegates (``protocol`` among them), and the chaos
harness's ``bandwidth_limited`` fault is this class.
"""

import io
import pickle

import pytest

from petastorm_tpu.test_util import chaos as jax_chaos
from petastorm_tpu.test_util import emulation as jax_emulation

from petastorm_tpu_torch.fs_utils import LocalFilesystem
from petastorm_tpu_torch.test_util import chaos, emulation


class _FakeFs(object):
    """In-memory inner filesystem: one blob per path, sizes exact."""

    protocol = 'file'

    def __init__(self, files):
        self._files = dict(files)
        self.size_calls = 0

    def open(self, path, mode='rb', **kwargs):
        if 'r' in mode and 'b' in mode:
            return io.BytesIO(self._files[path])
        return io.BytesIO()

    def size(self, path):
        self.size_calls += 1
        return len(self._files[path])


@pytest.fixture()
def sleeps(monkeypatch):
    """The sleeps of each package's run of a script (both modules sleep
    through the one ``time`` module)."""
    recorded = {'port': [], 'jax': [], 'now': []}
    monkeypatch.setattr(emulation.time, 'sleep', lambda s: recorded['now'].append(s))
    assert jax_emulation.time is emulation.time
    return recorded


def _both(files, script, sleeps=None, **kwargs):
    """``script(fs)`` over each package's wrapper of the same files: (the
    result, the inner size() calls) of the port, then of JAX; each one's
    sleeps land in ``sleeps['port']`` and ``sleeps['jax']``."""
    out = []
    for name, module in (('port', emulation), ('jax', jax_emulation)):
        inner = _FakeFs(files)
        if sleeps is not None:
            sleeps['now'] = sleeps[name]
        out.append((script(module.BandwidthLimitedFilesystem(inner, **kwargs)),
                    inner.size_calls))
    return out


def test_bandwidth_accounting_is_per_chunk_as_jax_s(sleeps):
    blob = bytes(600 * 1024)
    port, jax = _both({'/a': blob}, lambda fs: fs.open('/a').read(), sleeps, bps=1e6)
    assert port == jax and port[0] == blob
    assert sleeps['port'] == sleeps['jax']
    assert len(sleeps['port']) == 3 and sleeps['port'][0] == emulation._BW_CHUNK / 1e6
    assert sum(sleeps['port']) == pytest.approx(len(blob) / 1e6)


@pytest.mark.parametrize('n', [1, 100, 262144, 262145, 600000])
def test_a_bounded_read_pays_only_its_bytes_as_jax_s(sleeps, n):
    blob = bytes(512 * 1024)
    port, jax = _both({'/a': blob}, lambda fs: len(fs.open('/a').read(n)), sleeps, bps=1e6)
    assert port == jax and port[0] == min(n, len(blob))
    assert sleeps['port'] == sleeps['jax']
    assert sum(sleeps['port']) == pytest.approx(min(n, len(blob)) / 1e6)


def test_the_cold_latency_gate_by_size_as_jax_s(sleeps):
    files = {'/big': bytes(2 << 20), '/small': bytes(1024)}

    def script(fs):
        handle = fs.open('/big')
        handle.read(10)
        handle.read(10)
        fs.open('/big').read(10)
        fs.open('/small').read(10)
    port, jax = _both(files, script, sleeps, bps=1e9, cold_latency=1.2)
    assert port == jax
    assert sleeps['port'] == sleeps['jax']
    # once per handle of the big file, before its first read's bandwidth
    assert sleeps['port'].count(1.2) == 2 and sleeps['port'][0] == 1.2


def test_no_cold_latency_asks_no_size(sleeps):
    port, jax = _both({'/a': bytes(2 << 20)}, lambda fs: fs.open('/a').read(10), bps=1e9)
    assert port == jax and port[1] == 0


def test_write_handles_pass_through(sleeps):
    for module in (emulation, jax_emulation):
        fs = module.BandwidthLimitedFilesystem(_FakeFs({'/a': b'x'}), bps=1.0, cold_latency=9.0)
        handle = fs.open('/a', 'wb')
        handle.write(b'y')
        handle.close()
    assert sleeps['now'] == []


def test_the_wrapper_pickles_and_delegates(tmp_path):
    path = tmp_path / 'f.bin'
    path.write_bytes(b'0123456789')
    fs = pickle.loads(pickle.dumps(emulation.BandwidthLimitedFilesystem(
        LocalFilesystem(), bps=1e9, cold_latency=0.001, cold_threshold=1)))
    assert fs.protocol == 'file' and fs.size(str(path)) == 10
    assert fs.exists(str(path)) and fs.isfile(str(path))
    with fs.open(str(path)) as handle:
        assert handle.read(4) == b'0123' and handle.read() == b'456789'


def test_the_chaos_harness_s_fault_is_the_emulation():
    fs = chaos.FILESYSTEM_FAULTS['bandwidth_limited'](LocalFilesystem(), bps=20e6,
                                                      cold_latency=0.25, cold_threshold=1)
    assert isinstance(fs, emulation.BandwidthLimitedFilesystem)
    assert set(chaos.FILESYSTEM_FAULTS) == set(jax_chaos.FILESYSTEM_FAULTS)
    spec = chaos.SCENARIOS['fetch_latency_spike']['filesystem']
    assert spec == jax_chaos.SCENARIOS['fetch_latency_spike']['filesystem']
    built = chaos._build_fault_fs(spec)
    assert (built._bps, built._cold_latency, built._cold_threshold) == (20e6, 0.25, 1)
    assert 'fetch_latency_spike' in chaos.ported_scenarios()
