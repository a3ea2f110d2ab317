"""The materialization plane: decode once, serve warm.

Counterpart of ``petastorm_tpu/materialize/``.  Every cache tier before it
is reactive: decoded entries exist only after some consumer paid the cold
path, so a new tenant's first epoch still decodes.  Jobs here warm a dataset
ahead of demand, with capacity the autoscaler would otherwise drain:

* **pre-publish** (:class:`MaterializeController`): decode every piece
  through the consumer's own worker and publish the entries into the cluster
  cache plane under the digests the service's
  :class:`~petastorm_tpu_torch.service.cluster.ClusterCacheIdentity`
  computes, so that a later consumer's first epoch is all hits, equal to the
  decode path by construction; progress persists in a ledger
  (``kind='materialize_ledger'``) and every publish passes the plane's
  eviction-aware admission;
* **pre-transcode** (:mod:`~petastorm_tpu_torch.materialize.transcode`):
  columnar entries also published narrowed to their wire dtypes, under a
  ``:w{policy}`` key;
* **layout rewrite** (:mod:`~petastorm_tpu_torch.materialize.rewrite`):
  re-shard a dataset into row groups matched to the split geometry and the
  selected columns, through the one row sink :func:`write_rows`.

:func:`derive_candidates` names the dataset roots worth warming from the
provenance journals.  The dispatcher hands scale-in victims to an attached
controller (``Dispatcher.attach_materializer``).

Kill switch: ``PETASTORM_TPU_NO_MATERIALIZE=1`` turns every job off (the
controller constructs and refuses to run).  Admission refusals, entries
that cannot be encoded, reader arguments the identity does not understand
and columns no wire entry can hold all skip work; none raises.  Nothing in
this package loads torch.
"""

import os

KILL_SWITCH = 'PETASTORM_TPU_NO_MATERIALIZE'


def killed():
    """The materialization plane's kill switch."""
    return bool(os.environ.get(KILL_SWITCH))


from petastorm_tpu_torch.materialize.controller import (  # noqa: E402,F401
    MATERIALIZE_LEDGER_KIND, MaterializeController, derive_candidates)
from petastorm_tpu_torch.materialize.rewrite import (  # noqa: E402,F401
    layout_stats, rewrite_layout, write_rows)
from petastorm_tpu_torch.materialize.transcode import (  # noqa: E402,F401
    is_wire_entry, widen_entry, wire_entry, wire_key)

__all__ = ['KILL_SWITCH', 'killed', 'MaterializeController', 'MATERIALIZE_LEDGER_KIND',
           'derive_candidates', 'layout_stats', 'rewrite_layout', 'write_rows', 'wire_entry',
           'widen_entry', 'wire_key', 'is_wire_entry']
