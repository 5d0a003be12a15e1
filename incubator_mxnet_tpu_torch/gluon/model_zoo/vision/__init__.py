"""Vision models (port of ``incubator_mxnet_tpu/gluon/model_zoo/vision``):
ResNet v1/v2 (stock or ghost BN), AlexNet, VGG, SqueezeNet, DenseNet,
MobileNet v1/v2 and Inception v3, and the registry behind
:func:`get_model`."""
from . import alexnet as _alexnet_mod
from . import densenet as _densenet_mod
from . import inception as _inception_mod
from . import mobilenet as _mobilenet_mod
from . import resnet as _resnet_mod
from . import squeezenet as _squeezenet_mod
from . import vgg as _vgg_mod

_models = {}
for _mod in (_resnet_mod, _alexnet_mod, _vgg_mod, _squeezenet_mod,
             _densenet_mod, _mobilenet_mod, _inception_mod):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower() and \
                not _name.startswith("get_"):
            _models[_name] = _obj

# star-exports last (function names may shadow module names: `alexnet`)
from .resnet import *  # noqa: F401,F403,E402
from .alexnet import *  # noqa: F401,F403,E402
from .vgg import *  # noqa: F401,F403,E402
from .squeezenet import *  # noqa: F401,F403,E402
from .densenet import *  # noqa: F401,F403,E402
from .mobilenet import *  # noqa: F401,F403,E402
from .inception import *  # noqa: F401,F403,E402


def get_model(name, **kwargs):
    """The zoo's model ``name`` (case-insensitive), built with ``kwargs``
    (``classes``, ``device``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %r not found; available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
