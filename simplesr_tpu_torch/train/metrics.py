"""Host-side metric accumulators, as simplesr_tpu.train.metrics.

The training step hands back ``{name: scalar tensor}`` dicts. The
accumulators keep the tensors as they are, on their device, and read them
only when ``result()`` is called: one stack and one copy to the host then,
so that bookkeeping never waits for the device inside the step loop.
"""

import numpy as np
import torch


class MeanMetric:
    """Streaming mean of scalars (tf.keras.metrics.Mean)."""

    def __init__(self):
        self._values = []

    def __call__(self, value):
        self._values.append(value)

    update = __call__

    def result(self):
        if not self._values:
            return float("nan")
        tensors = [v for v in self._values if isinstance(v, torch.Tensor)]
        if tensors:
            device = tensors[0].device
            stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device)
                                   .reshape(()) for v in self._values])
            return float(stacked.mean())
        return float(np.mean([np.asarray(v, dtype=np.float64) for v in self._values]))

    def reset_states(self):
        self._values = []

    @property
    def count(self):
        return len(self._values)


class MetricBundle:
    """A named dict of MeanMetrics with bulk update, reset and results."""

    def __init__(self, names=()):
        self.metrics = {n: MeanMetric() for n in names}

    def ensure(self, name):
        if name not in self.metrics:
            self.metrics[name] = MeanMetric()
        return self.metrics[name]

    def update(self, values):
        for name, v in values.items():
            self.ensure(name)(v)

    def results(self):
        return {n: m.result() for n, m in self.metrics.items() if m.count}

    def last_values(self):
        """The last value per metric, as it was given (no device sync)."""
        return {n: m._values[-1] for n, m in self.metrics.items() if m.count}

    def reset(self):
        for m in self.metrics.values():
            m.reset_states()

    def __getitem__(self, name):
        return self.metrics[name]

    def __contains__(self, name):
        return name in self.metrics

    def keys(self):
        return self.metrics.keys()
