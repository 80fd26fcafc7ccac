from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg  # noqa: F401
from fedml_tpu_torch.models.linear import LogisticRegression  # noqa: F401
from fedml_tpu_torch.models.transformer import TransformerLM  # noqa: F401
