"""The four metric histories as JSON files, as
simplesr_tpu.utils.train_result: ``<model>_<history>.json`` each."""

import json
import os

import torch


class TrainResult:
    def __init__(self, model_name, train_batch_history, train_epoch_history,
                 valid_batch_history, valid_epoch_history, config=None):
        self.model_name = model_name
        self.train_batch_history = train_batch_history
        self.train_epoch_history = train_epoch_history
        self.valid_batch_history = valid_batch_history
        self.valid_epoch_history = valid_epoch_history
        self.config = config

    def save_as_json(self, save_dir):
        os.makedirs(save_dir, exist_ok=True)
        histories = {
            "train_batch_history": self.train_batch_history,
            "train_epoch_history": self.train_epoch_history,
            "valid_batch_history": self.valid_batch_history,
            "valid_epoch_history": self.valid_epoch_history,
        }
        for name, history in histories.items():
            path = os.path.join(save_dir, f"{self.model_name}_{name}.json")
            with open(path, "w") as f:
                json.dump({k: self._to_floats(vals) for k, vals in history.items()},
                          f, indent=2)
        return list(histories)

    @staticmethod
    def _to_floats(vals):
        """A history list as floats, with its tensors gathered in one
        device-to-host copy (the batch histories hold the step's tensors)."""
        tensors = [v for v in vals if isinstance(v, torch.Tensor)]
        if not tensors:
            return [float(v) for v in vals]
        device = tensors[0].device
        stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
                               for v in vals])
        return [float(x) for x in stacked.cpu().tolist()]
