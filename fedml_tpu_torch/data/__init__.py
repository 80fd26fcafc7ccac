from fedml_tpu_torch.data.registry import load_data  # noqa: F401
from fedml_tpu_torch.data.stacking import (  # noqa: F401
    FederatedData, batch_global, gather_cohort, stack_client_data)
