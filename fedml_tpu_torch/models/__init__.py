from fedml_tpu_torch.models.cnn import (  # noqa: F401
    CNNDropOut, CNNOriginalFedAvg)
from fedml_tpu_torch.models.linear import LogisticRegression  # noqa: F401
from fedml_tpu_torch.models.transformer import TransformerLM  # noqa: F401
from fedml_tpu_torch.models.resnet import (  # noqa: F401
    resnet18_gn, resnet56, resnet110)
