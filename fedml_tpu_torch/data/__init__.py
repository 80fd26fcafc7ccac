from fedml_tpu_torch.data.registry import (  # noqa: F401
    dataset_names, load_data, register_dataset)
from fedml_tpu_torch.data.stacking import (  # noqa: F401
    FederatedData, batch_global, gather_cohort, stack_client_data)
from fedml_tpu_torch.data.synthetic import (  # noqa: F401
    generate_synthetic_alpha_beta, load_synthetic,
    synthetic_federated_dataset)
