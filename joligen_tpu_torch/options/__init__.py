from .registry import (
    Opt,
    OptionRegistry,
    TrainOptions,
    InferenceOptions,
    flatten_json,
    unflatten_json,
)

__all__ = [
    "Opt",
    "OptionRegistry",
    "TrainOptions",
    "InferenceOptions",
    "flatten_json",
    "unflatten_json",
]
