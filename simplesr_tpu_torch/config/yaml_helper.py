"""YAML helpers, as simplesr_tpu.config.yaml_helper: loading a config,
loss functors by class name, augmentation-name checks, resize-filter names,
and a string-to-object importer. Files are read with the port's own reader
(``config/_yaml.py``); ``!!python/tuple`` values load as tuples."""

import importlib

from simplesr_tpu_torch.config import _yaml
from simplesr_tpu_torch.losses import LOSS_REGISTRY
from simplesr_tpu_torch.ops import augment as augment_ops

YAML_GENERAL_KEY = "general"
YAML_AUGMENTATION_KEY = "augmentations"
YAML_RESIZE_FILTER_KEY = "resize_filter"
YAML_MODEL_KEY = "model"
YAML_GENERATOR_KEY = "generator"
YAML_GENERATOR_OPTIMIZER_KEY = "generator_optimizer"


def load_yaml(config_yaml_path):
    """Load a YAML path (or pass an already-loaded dict through)."""
    if isinstance(config_yaml_path, dict):
        return config_yaml_path
    return _yaml.load(config_yaml_path)


def init_loss_functions_from_yaml(config_yaml):
    """[{loss_function: ClassName, **kwargs}, ...] -> functor instances."""
    out = []
    for spec in config_yaml["loss_functions"]:
        name = spec["loss_function"]
        if name not in LOSS_REGISTRY:
            raise ValueError(f"unknown loss function {name!r}; "
                             f"options: {sorted(LOSS_REGISTRY)}")
        params = {k: v for k, v in spec.items() if k != "loss_function"}
        out.append(LOSS_REGISTRY[name](**params))
    return out


def init_augmentations(config_yaml):
    """Check the names in general.augmentations (the pipeline takes names)."""
    general = config_yaml.get(YAML_GENERAL_KEY, {})
    augs = general.get(YAML_AUGMENTATION_KEY)
    if not augs:
        return config_yaml
    for name in augs:
        if name not in augment_ops.AUGMENTATIONS:
            raise ValueError(
                f"unknown augmentation {name!r}; "
                f"options: {augment_ops.get_all_available_augmentations()}")
    return config_yaml


def prepare_for_training_config(config_yaml):
    return init_augmentations(config_yaml)


def prepare_for_evaluation_config(config_yaml):
    """Lower-case the resize filter's name."""
    general = config_yaml.get(YAML_GENERAL_KEY, {})
    rf = general.get(YAML_RESIZE_FILTER_KEY)
    if rf is not None:
        general[YAML_RESIZE_FILTER_KEY] = str(rf).lower()
    return config_yaml


def string_to_lib_object(lib, modules):
    """("torch.optim", ["Adam"]) -> torch.optim.Adam. Only ``torch``
    namespaces resolve."""
    if lib != "torch" and not lib.startswith("torch."):
        raise ValueError(f"{lib!r} is not a torch namespace")
    obj = importlib.import_module(lib)
    for module in modules:
        obj = getattr(obj, module)
    return obj
