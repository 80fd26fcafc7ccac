"""Upload admission: the per-upload screens and the trust ledger."""

from fedml_tpu_torch.robust.admission import (REASONS,  # noqa: F401
                                              AdmissionPipeline,
                                              AdmissionVerdict, TrustTracker)
