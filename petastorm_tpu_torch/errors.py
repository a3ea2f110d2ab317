"""Framework-wide exception types.

Counterpart of ``petastorm_tpu/errors.py`` (a copy: the port imports
nothing of the JAX package).
"""


class PetastormTpuError(Exception):
    """Base class for all first-party errors."""


class NoDataAvailableError(PetastormTpuError):
    """Raised when a reader is constructed over a selection that yields no rows
    (e.g. all row groups pruned by sharding)."""


class MetadataError(PetastormTpuError):
    """Raised when dataset footer metadata is missing or malformed."""


class DecodeFieldError(PetastormTpuError):
    """Raised when a codec fails to decode a field value."""


class PoisonedRowGroupError(PetastormTpuError):
    """A row group kept failing after ``read_retries`` retries with backoff.

    Carries the piece identity so operators can quarantine or repair the
    exact row group.
    """

    def __init__(self, path, row_group, attempts, cause):
        self.path = path
        self.row_group = row_group
        self.attempts = attempts
        self.cause = str(cause)
        super(PoisonedRowGroupError, self).__init__(
            'Row group %d of %r still failing after %d attempt(s): %s'
            % (row_group, path, attempts, self.cause))


class ServiceError(PetastormTpuError):
    """A data-service RPC was rejected by its peer (the dispatcher refused a
    request, or a resume token's partition geometry does not match the
    running job)."""


class ServiceRpcTimeoutError(ServiceError):
    """A control-plane RPC got no reply within its timeout: the peer is down
    or unreachable.  The REQ socket has been rebuilt, so retrying the call
    is safe."""
