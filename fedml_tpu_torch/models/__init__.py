from fedml_tpu_torch.models.cnn import (  # noqa: F401
    CNNDropOut, CNNOriginalFedAvg)
from fedml_tpu_torch.models.linear import LogisticRegression  # noqa: F401
from fedml_tpu_torch.models.transformer import TransformerLM  # noqa: F401
from fedml_tpu_torch.models.resnet import (  # noqa: F401
    resnet18_gn, resnet56, resnet110)
from fedml_tpu_torch.models.mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV3, mobilenet, mobilenet_v3)
from fedml_tpu_torch.models.rnn import (  # noqa: F401
    RNNOriginalFedAvg, RNNStackOverflow)
from fedml_tpu_torch.models.efficientnet import (  # noqa: F401
    EfficientNet, efficientnet)
from fedml_tpu_torch.models.moe import SwitchFFN  # noqa: F401
from fedml_tpu_torch.models.vgg import (  # noqa: F401
    VGG, VGG16Features, perceptual_loss, vgg11, vgg13, vgg16)
