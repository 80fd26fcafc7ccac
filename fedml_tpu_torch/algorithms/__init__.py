from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig  # noqa: F401
from fedml_tpu_torch.algorithms.fedavg_robust import (  # noqa: F401
    FedAvgRobust, FedAvgRobustConfig)
from fedml_tpu_torch.algorithms.turboaggregate import (  # noqa: F401
    TurboAggregate, TurboAggregateConfig)
from fedml_tpu_torch.algorithms.centralized import (  # noqa: F401
    CentralizedTrainer)
