"""Generator wrapper, as simplesr_tpu.train.generator: the generator
module, its loss functors and metric bookkeeping.

Same constructor surface, factories (``srresnet``, ``rrdb``,
``srgan_generator``, ``esrgan_generator``) with the papers' loss stacks,
``from_yaml``, ``module_config`` (the config a model file stores) and metric
names ("generator_loss", one mean per loss functor, ``weighted_`` variants)
as the JAX package. The module lives on one device and ``SRModel`` trains
its parameters in place; ``variables`` gives them in flax's layout.
Parameters are initialised from ``seed`` as flax initialises them
(glorot-uniform, lecun-normal or scaled he-normal kernels, zero biases and
PReLU slopes), but from torch's generator: the same seed gives other
numbers than JAX's.

A warm start takes the module from ``pretrained_model`` (a ``Generator``,
or ``(module, variables)`` with the variables in flax's layout, or None for
the module as it is) or from ``pretrained_model_path`` (a model file). The
architecture is then the pretrained one's, whatever the other arguments
say, as in the JAX package. ``module_config`` is that of the pretrained
``Generator`` or file, where the JAX package gives the constructor's
arguments: a model file saved from a BN-free pretrained SRResNet says
``batch_norm: false`` even when the YAML file asked for BatchNorm (the JAX
package writes the YAML's value beside BN-free variables, and that file
does not load). For ``(module, variables)`` both give the constructor's
arguments.
"""

import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.core.dtypes import dtype_from_name
from simplesr_tpu_torch.losses import (AdversarialLoss, MeanAbsoluteError, MeanSquaredError,
                                       RaAdversarialLoss, VGGLoss, adapt_generator_loss)
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.train import serialization
from simplesr_tpu_torch.train.convert import from_flax_variables, to_flax_variables
from simplesr_tpu_torch.train.metrics import MetricBundle


class Generator:
    def __init__(self,
                 upsample_factor,
                 architecture,
                 loss_functions,
                 num_blocks=16,
                 num_dense_blocks=3,
                 num_filters=64,
                 num_convs=4,
                 kernel_size=3,
                 residual_scaling=0.2,
                 kernel_initializer=None,
                 batch_norm=False,
                 input_dims=(None, None),
                 pretrained_model_path=None,
                 pretrained_model=None,
                 dtype=None,
                 growth_channels=None,
                 remat=False,
                 seed=0,
                 device="cuda"):
        del kernel_initializer, input_dims  # fixed initialisers; no shapes to trace
        self._architecture = architecture
        self._upsample_factor = upsample_factor
        if loss_functions is None or (isinstance(loss_functions, list) and not loss_functions):
            raise ValueError("no loss function for generator supplied")
        if not isinstance(loss_functions, list):
            loss_functions = [loss_functions]
        self._loss_functions = [adapt_generator_loss(f) for f in loss_functions]

        names = ["generator_loss"]
        for idx, f in enumerate(self._loss_functions):
            name = getattr(f, "name", f"loss_function_{idx}")
            names.append(name)
            if getattr(f, "weighted", False):
                names.append(f"weighted_{name}")
        self._batch_metrics = MetricBundle(names)
        self._epoch_metrics_train = MetricBundle(names)
        self._epoch_metrics_valid = MetricBundle(names)

        self._dtype = dtype_from_name(dtype)
        self._num_blocks = num_blocks
        self._num_dense_blocks = num_dense_blocks
        self._num_filters = num_filters
        self._num_convs = num_convs
        self._kernel_size = kernel_size
        self._residual_scaling = residual_scaling
        self._growth_channels = growth_channels
        self._remat = remat  # the module's (models.build_generator_model), and module_config's
        self._batch_norm = batch_norm

        device = resolve_device(device)
        self._pretrained_config = None
        if pretrained_model is not None:
            if isinstance(pretrained_model, Generator):
                self._pretrained_config = pretrained_model.module_config()
                self._module = pretrained_model.model()
            else:
                self._module, variables = pretrained_model
                if variables is not None:
                    self._module.load_state_dict(from_flax_variables(self._module, variables))
            self._module = self._module.to(device)
        elif pretrained_model_path is not None:
            self._pretrained_config, _ = serialization.load_payload(pretrained_model_path)
            self._module = serialization.load_model(pretrained_model_path, device=device)
        else:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                self._module = build_generator_model(
                    upsample_factor=upsample_factor, architecture=architecture,
                    num_blocks=num_blocks, num_filters=num_filters, kernel_size=kernel_size,
                    residual_scaling=residual_scaling, batch_norm=batch_norm,
                    num_convs=num_convs, num_dense_blocks=num_dense_blocks, dtype=dtype,
                    growth_channels=growth_channels, remat=remat, device="cpu")
            self._module = self._module.to(device)

    # ------------------------------------------------------------ access

    def model(self):
        """The generator module."""
        return self._module

    @property
    def device(self):
        return next(self._module.parameters()).device

    def to(self, device):
        self._module = self._module.to(resolve_device(device))
        return self

    @property
    def variables(self):
        """The module's variables in flax's layout (CPU copies)."""
        return to_flax_variables(self._module.state_dict())

    def set_variables(self, variables):
        """Load ``variables`` (flax's layout, as ``variables`` gives them)
        into the module."""
        self._module.load_state_dict(from_flax_variables(self._module, variables))

    def set_model(self, module, variables=None):
        """Use ``module`` as the generator, with ``variables`` loaded into it
        when given."""
        self._module = module
        if variables is not None:
            self.set_variables(variables)

    def loss_functions(self):
        return self._loss_functions

    def module_config(self):
        if self._pretrained_config is not None:
            return dict(self._pretrained_config)
        return dict(
            upsample_factor=self._upsample_factor, architecture=self._architecture,
            num_blocks=self._num_blocks, num_dense_blocks=self._num_dense_blocks,
            num_filters=self._num_filters, num_convs=self._num_convs,
            kernel_size=self._kernel_size, residual_scaling=self._residual_scaling,
            batch_norm=self._batch_norm,
            growth_channels=self._growth_channels,
            remat=self._remat,
            dtype=str(self._dtype).removeprefix("torch."))

    def batch_metrics(self):
        return self._batch_metrics

    def epoch_metrics(self, train=True):
        return self._epoch_metrics_train if train else self._epoch_metrics_valid

    def reset_epoch_metrics(self):
        self._epoch_metrics_train.reset()
        self._epoch_metrics_valid.reset()

    def reset_batch_metrics(self):
        self._batch_metrics.reset()

    # ------------------------------------------------------------ compute

    def generate(self, lr_batch):
        """SR a batch (NHWC in [0, 1], a tensor or an array) with the current
        parameters, in eval mode, on the module's device."""
        x = torch.as_tensor(lr_batch, dtype=torch.float32).to(self.device)
        self._module.eval()
        with torch.inference_mode():
            return self._module(x)

    def calculate_loss(self, sr_batch, hr_batch, sr_critic, hr_critic):
        """Sum over the loss functors -> (total, metrics)."""
        total = 0.0
        metrics = {}
        for f in self._loss_functions:
            loss, m = f(hr_batch, sr_batch, hr_critic, sr_critic)
            total = total + loss
            metrics.update(m)
        metrics["generator_loss"] = total
        return total, metrics

    def accumulate_metrics(self, metrics, train=True):
        self._batch_metrics.update(metrics)
        self.epoch_metrics(train).update(metrics)

    def formatted_epoch_metrics(self, train=True):
        m = self.epoch_metrics(train).results()
        out = f"\ttotal loss: {m.get('generator_loss', float('nan')):.5f}\n"
        for name, val in m.items():
            if name != "generator_loss":
                out += f"\t{name}: {val:.5f}\n"
        return out

    def __str__(self):
        loss_info = "".join(str(f) for f in self._loss_functions)
        return ("# Generator\n"
                f"architecture: {self._architecture}\n"
                f"upsample factor: {self._upsample_factor}\n"
                f"loss functions:\n {loss_info}\n"
                f"number of residual blocks: {self._num_blocks}\n"
                f"number of filters: {self._num_filters}\n")

    # ------------------------------------------------------------ factories

    @staticmethod
    def srresnet(upsample_factor, loss_function=None, num_blocks=16, num_filters=64,
                 kernel_size=3, batch_norm=True, input_dims=(None, None),
                 pretrained_model_path=None, **kw):
        """SRResNet, pixel MSE by default."""
        if loss_function is None:
            loss_function = [MeanSquaredError(weighted=False, loss_weight=1.0)]
        return Generator(
            upsample_factor=upsample_factor, architecture="srresnet",
            loss_functions=loss_function, num_blocks=num_blocks,
            num_filters=num_filters, kernel_size=kernel_size,
            batch_norm=batch_norm, input_dims=input_dims,
            pretrained_model_path=pretrained_model_path, **kw)

    @staticmethod
    def rrdb(upsample_factor, loss_functions=MeanAbsoluteError, loss_weight=1.0,
             num_blocks=16, num_dense_blocks=3, num_filters=64, num_convs=4,
             kernel_size=3, residual_scaling=0.2, kernel_initializer=None,
             batch_norm=False, input_dims=(None, None), pretrained_model_path=None,
             pretrained_model=None, **kw):
        """RRDB, pixel MAE by default (``loss_functions`` is a loss class)."""
        weighted = loss_weight != 1.0
        return Generator(
            upsample_factor=upsample_factor, architecture="rrdb",
            loss_functions=[loss_functions(weighted=weighted, loss_weight=loss_weight)],
            num_blocks=num_blocks, num_dense_blocks=num_dense_blocks,
            num_filters=num_filters, num_convs=num_convs, kernel_size=kernel_size,
            residual_scaling=residual_scaling, kernel_initializer=kernel_initializer,
            batch_norm=batch_norm, input_dims=input_dims,
            pretrained_model_path=pretrained_model_path, pretrained_model=pretrained_model,
            **kw)

    @staticmethod
    def srgan_generator(upsample_factor, vgg_loss=True, vgg_layer="block5_conv4",
                        vgg_feature_scaling=1 / 12.75, vgg_loss_weight=1.0,
                        adversarial_loss_weight=1e-3, num_blocks=16, num_filters=64,
                        kernel_size=3, batch_norm=True, input_dims=(None, None),
                        pretrained_model_path=None, pretrained_model=None,
                        vgg_weights_path=None, **kw):
        """The SRGAN paper's recipe: post-activation VGG54 perceptual loss
        (or MSE when ``vgg_loss`` is off) and adversarial 1e-3."""
        if vgg_loss:
            losses = [VGGLoss(vgg_layer, feature_scale=vgg_feature_scaling,
                              loss_weight=vgg_loss_weight, after_activation=True,
                              custom_weights_path=vgg_weights_path)]
        else:
            losses = [MeanSquaredError(weighted=False, loss_weight=1.0)]
        losses.append(AdversarialLoss(weighted=(adversarial_loss_weight != 1.0),
                                      loss_weight=adversarial_loss_weight))
        return Generator(
            upsample_factor=upsample_factor, architecture="srresnet", loss_functions=losses,
            num_blocks=num_blocks, num_filters=num_filters, kernel_size=kernel_size,
            batch_norm=batch_norm, input_dims=input_dims,
            pretrained_model_path=pretrained_model_path, pretrained_model=pretrained_model,
            **kw)

    @staticmethod
    def esrgan_generator(upsample_factor, vgg_layer="block5_conv4", vgg_feature_scaling=1.0,
                         vgg_loss_weight=1.0, adversarial_loss_weight=5e-3,
                         l1_loss_weight=1e-2, num_blocks=16, num_dense_blocks=3,
                         num_filters=64, num_convs=4, kernel_size=3, input_dims=(None, None),
                         pretrained_model_path=None, pretrained_model=None,
                         vgg_weights_path=None, **kw):
        """The ESRGAN paper's recipe: L1 1e-2, relativistic adversarial 5e-3
        and pre-activation VGG54."""
        return Generator(
            upsample_factor=upsample_factor, architecture="rrdb",
            loss_functions=[
                MeanAbsoluteError(weighted=True, loss_weight=l1_loss_weight),
                RaAdversarialLoss(weighted=True, loss_weight=adversarial_loss_weight),
                VGGLoss(output_layers=vgg_layer, feature_scale=vgg_feature_scaling,
                        loss_weight=vgg_loss_weight, after_activation=False,
                        custom_weights_path=vgg_weights_path),
            ],
            num_blocks=num_blocks, num_dense_blocks=num_dense_blocks, num_filters=num_filters,
            num_convs=num_convs, kernel_size=kernel_size, residual_scaling=0.2,
            batch_norm=False, input_dims=input_dims,
            pretrained_model_path=pretrained_model_path, pretrained_model=pretrained_model,
            **kw)

    @staticmethod
    def from_yaml(config_yaml, device="cuda"):
        """The generator of a YAML config (a path or its loaded dict), its
        ``model.generator`` section with the loss functors built by name."""
        from simplesr_tpu_torch.config import yaml_helper

        conf = yaml_helper.load_yaml(config_yaml)
        gen_conf = dict(conf["model"]["generator"])
        gen_conf["loss_functions"] = yaml_helper.init_loss_functions_from_yaml(gen_conf)
        gen_conf.pop("loss_functions_yaml", None)
        return Generator(**gen_conf, device=device)

