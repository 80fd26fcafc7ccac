"""The closed fault-attribution vocabulary of the admission screens.

A port-local copy of ``FaultClass`` from ``fedml_tpu/robust/degrade.py``;
the reliability tracker and the rest of that module are not ported yet
(ROADMAP Queue 1)."""


class FaultClass:
    """``NETWORK`` — the wire failed, not the silo (dead letters, deadline
    drops, partitions): never strikes trust.  ``PAYLOAD`` — the silo's own
    bytes are the offense (fingerprint / nonfinite / norm-outlier /
    bad-sample-count verdicts): the only class allowed to strike.
    ``UNKNOWN`` — damage whose origin cannot be pinned: never strikes."""

    NETWORK = "network"
    PAYLOAD = "payload"
    UNKNOWN = "unknown"
    ALL = (NETWORK, PAYLOAD, UNKNOWN)
