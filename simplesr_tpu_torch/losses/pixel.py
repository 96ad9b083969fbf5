"""Pixel losses, as simplesr_tpu.losses.pixel: MSE (SRResNet) and MAE
(ESRGAN's content loss), in float32, with the same names and metric keys."""

from simplesr_tpu_torch.losses.base import Loss


class MeanSquaredError(Loss):
    name = "mean_squared_error"

    def __call__(self, hr_batch, sr_batch, hr_critic=None, sr_critic=None):
        return self._package(((hr_batch.float() - sr_batch.float()) ** 2).mean())


class MeanAbsoluteError(Loss):
    name = "mean_absolute_error"

    def __call__(self, hr_batch, sr_batch, hr_critic=None, sr_critic=None):
        return self._package((hr_batch.float() - sr_batch.float()).abs().mean())
