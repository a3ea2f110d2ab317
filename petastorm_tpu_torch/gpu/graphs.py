"""One dispatch per step on the card: a step captured once as a CUDA graph
and replayed.

The JAX package compiles its train step with ``jax.jit`` (one dispatch a
step) and folds many steps into one dispatch with ``lax.scan``
(``DataLoader.scan_batches``, ``DeviceInMemDataLoader.scan_epochs``,
``generate``'s token loop).  PyTorch runs eagerly, one kernel launch at a
time from Python; the counterpart here is a CUDA graph of the step, captured
once at static shapes from static input slots, then replayed: one graph
launch per step, whatever the number of kernels in it.

A :class:`StepGraph` is called once per step.  It

* runs its first call eagerly on a side stream (the warm-up), as PyTorch's
  whole-network capture recipe does, so that what a step makes lazily
  (optimizer state, library handles and workspaces, the kernels'
  libraries, which are built at first use) exists before capture.  A
  warm-up step is a real step on a real batch;
* at its second call copies the inputs into static slots, records the step
  on them (a capture executes nothing) and replays it, so that this step
  too runs on its batch;
* at every later call fills the slots from the new inputs with a copy on
  the current stream, the one the replay runs on (a copy on another stream
  would race the previous replay, which still reads the slot), and
  replays.

A captured step replays only on inputs of the shapes it was captured on:
:func:`copy_into` raises on any other, and a caller whose shapes vary keeps
one graph per :func:`signature`, as ``jax.jit`` keeps one compile per
shape.  Every device ``torch.Generator`` the step draws from is registered
with the graph, so each replay draws what the eager step would have drawn
next.  Python inside the step runs once, at capture: the step must not
branch on device values or keep host state.  A replay runs inside a
``torch.profiler.record_function`` range (``train_step`` unless named
otherwise), where the eager step opens its own; a capture runs inside one
named :data:`CAPTURE_RANGE`, so that a profile tells the step's ranges
recorded at capture (which run nothing) from those that ran.  Kernel
wrappers that count their launches register with :func:`counts_launches`: a
capture adds nothing to their counters, and each replay adds the launches
the capture recorded.

Graphs exist only on the card.  :func:`resolve` decides from the device and
the caller's ``cuda_graph`` keyword: the CPU runs the eager loop, which the
tests hold against the JAX package and which the card's replay is held
against; asking for a graph on the CPU raises.  Nothing falls back: a
capture or replay that fails raises.

A capture runs with every loader's transfer thread parked
(:func:`~petastorm_tpu_torch.gpu.transfer.pumps_paused`): that thread
pins, copies and waits on events, and a CUDA call of another thread during
a capture fails it (in CUDA's default global mode).  The threads resume
after the capture.  It also runs with Python's cyclic garbage collector
collected first and then held off: a collection during the capture that
frees an unreachable CUDA graph (:class:`_EpochGraph` of the device cache
is one: it refers to itself through its step) destroys that graph inside
the capture, which invalidates the capture ("operation not permitted when
stream is capturing").
"""

import contextlib
import gc

import torch

from petastorm_tpu_torch.gpu.transfer import pumps_paused

__all__ = ['resolve', 'StepGraph', 'counts_launches', 'signature', 'tree_map', 'copy_into',
           'write_at']


def resolve(cuda_graph, device):
    """Whether a loop on ``device`` replays a CUDA graph: ``None`` means yes
    on the card and no on the CPU; ``True`` on the CPU raises."""
    device = torch.device(device)
    if cuda_graph is None:
        return device.type == 'cuda'
    if cuda_graph and device.type != 'cuda':
        raise ValueError('cuda_graph=True needs the card; on %s the loop runs eagerly '
                         '(pass cuda_graph=None or False)' % (device,))
    return bool(cuda_graph)


def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError('a step graph takes tensors (in dicts, lists and tuples) and None, '
                    'got %s' % (type(tree).__name__,))


def signature(tree):
    """The shapes and dtypes of a tree's tensors, in a hashable form: the
    inputs one captured step replays on."""
    leaves = []
    tree_map(lambda t: leaves.append((tuple(t.shape), t.dtype)), tree)
    return tuple(leaves)


def copy_into(dst, src):
    """Copy the tensors of ``src`` into the like-shaped tree ``dst``; a
    tensor of another shape raises (``copy_`` would broadcast it)."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape:
            raise ValueError('a step graph replays on inputs of its captured shape %s, got %s'
                             % (tuple(dst.shape), tuple(src.shape)))
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k])
    else:
        for d, s in zip(dst, src):
            copy_into(d, s)


def write_at(buffers, index, value):
    """``buffers[index] = value`` over like trees, ``index`` a one-element
    device tensor (a position a captured step can advance)."""
    if isinstance(buffers, torch.Tensor):
        buffers.index_copy_(0, index, value.unsqueeze(0))
    elif isinstance(buffers, dict):
        for name, buffer in buffers.items():
            write_at(buffer, index, value[name])
    elif buffers is not None:
        for buffer, item in zip(buffers, value):
            write_at(buffer, index, item)


#: The kernel wrappers whose launch counters replays keep (see
#: :func:`counts_launches`).
_COUNTED = []


def counts_launches(wrapper):
    """Register a kernel wrapper that counts the launches it makes in its
    ``launches`` (an int) and ``launches_by_design`` (a dict of ints)
    attributes, so that they count launches that ran on the card: a capture
    adds nothing, and each replay adds the capture's launches.  Returns
    ``wrapper``."""
    _COUNTED.append(wrapper)
    return wrapper


def _launch_counts():
    return [(kernel.launches, dict(kernel.launches_by_design)) for kernel in _COUNTED]


def _set_launch_counts(counts):
    for kernel, (launches, by_design) in zip(_COUNTED, counts):
        kernel.launches = launches
        kernel.launches_by_design = dict(by_design)


def _add_launch_counts(delta):
    for kernel, (launches, by_design) in zip(_COUNTED, delta):
        kernel.launches += launches
        for design, n in by_design.items():
            kernel.launches_by_design[design] += n


#: The profiler range around each capture (see the module docstring).
CAPTURE_RANGE = 'cuda_graph_capture'


class _Cuda(object):
    """The CUDA side of a step graph (tests put a fake in its place)."""

    @staticmethod
    def side_stream():
        return torch.cuda.Stream()

    @staticmethod
    def run_on(stream, fn, args):
        """``fn(*args)`` eagerly on ``stream``, after the current stream's
        work and before its next."""
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(*args)
        current.wait_stream(stream)
        # made on the side stream, used on the current one from now on
        tree_map(lambda t: t.record_stream(current), out)
        return out

    @staticmethod
    def capture(fn, args, stream, generators):
        """Record ``fn(*args)`` on ``stream``; returns ``(graph, outputs)``."""
        graph = torch.cuda.CUDAGraph()
        for generator in generators:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=stream):
            out = fn(*args)
        return graph, out

    @staticmethod
    def replay(graph):
        graph.replay()


BACKEND = _Cuda


@contextlib.contextmanager
def _collector_held():
    """Collect Python's cyclic garbage, then keep the collector off for the
    duration (see the module docstring)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph(object):
    """``step(*inputs) -> outputs``, one call per step: the first call runs
    ``fn`` eagerly (the warm-up), the second captures it on its inputs and
    replays it, every later one replays it on its inputs (see the module
    docstring).  Inputs and outputs are trees of tensors (dicts, lists and
    tuples; None); the outputs a call returns are the caller's to keep (a
    replay's static outputs, cloned).  ``generators`` are the device
    generators ``fn`` draws from; ``range_name`` names each replay's
    profiler range.

    One warm-up step is what a train step needs (PyTorch's recipe runs
    three): its optimizer state and the libraries' handles and workspaces on
    the side stream are made by the first eager step, and the second step
    takes the path every later one takes."""

    def __init__(self, fn, generators=(), range_name='train_step'):
        self._fn = fn
        self._generators = tuple(generators)
        self._range_name = range_name
        self._stream = BACKEND.side_stream()
        self._warm = False
        self._graph = None
        self._slots = None
        self._per_replay = None
        #: The static outputs, rewritten by each replay.
        self.outputs = None

    def __call__(self, *inputs):
        if not self._warm:
            self._warm = True
            return BACKEND.run_on(self._stream, self._fn, inputs)
        if self._graph is None:
            self.capture(*inputs)
            out = self.replay()
        else:
            out = self.replay(*inputs)
        return tree_map(torch.clone, out)

    def capture(self, *inputs):
        """Copy ``inputs`` into new static slots and record one step on them
        (nothing runs); returns the static outputs."""
        if self._graph is not None:
            raise RuntimeError('this step is captured already')
        self._slots = tree_map(torch.clone, inputs)
        before = _launch_counts()
        with pumps_paused(), _collector_held(), torch.profiler.record_function(CAPTURE_RANGE):
            self._graph, self.outputs = BACKEND.capture(self._fn, self._slots, self._stream,
                                                        self._generators)
        after = _launch_counts()
        self._per_replay = [(a - b, {d: n - by_b[d] for d, n in by_a.items()})
                            for (a, by_a), (b, by_b) in zip(after, before)]
        _set_launch_counts(before)
        return self.outputs

    def replay(self, *inputs):
        """Copy ``inputs`` (if given) into the static slots on the current
        stream and replay the step; returns the static outputs."""
        if self._graph is None:
            raise RuntimeError('replay before capture')
        with torch.profiler.record_function(self._range_name):
            if inputs:
                copy_into(self._slots, inputs)
            BACKEND.replay(self._graph)
        _add_launch_counts(self._per_replay)
        return self.outputs
