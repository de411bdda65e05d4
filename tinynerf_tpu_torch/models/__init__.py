from .encodings import posenc_dim, positional_encoding
from .kplanes import KPlanesFeatureField
from .mlp import MLP, linear_apply, mlp_apply, mlp_apply_split, mlp_apply_split_per_ray
from .registry import METHODS, make_model
from .vanilla import ColorDecoder, OpacityDecoder

__all__ = [
    "positional_encoding",
    "posenc_dim",
    "KPlanesFeatureField",
    "MLP",
    "linear_apply",
    "mlp_apply",
    "mlp_apply_split",
    "mlp_apply_split_per_ray",
    "METHODS",
    "make_model",
    "ColorDecoder",
    "OpacityDecoder",
]
