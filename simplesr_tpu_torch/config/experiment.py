"""Experiment: config-grid sweeps, as simplesr_tpu.config.experiment.

A list of ``{name: {overrides}}`` dicts; each experiment's config is a deep
copy of the base config with its overrides applied and its own save
directory (``<save_path>/<name>``), yielded one at a time. ``add_result``
collects each run's histories as a ``TrainResult``.
"""

import copy

from simplesr_tpu_torch.utils.train_result import TrainResult


class Experiment:
    def __init__(self, base_config, experiment_params, include_base_config):
        self.base_config = base_config
        self.current_config = base_config
        self.current_experiment_name = None
        if include_base_config:
            self.experiment_params = [{"base config": {}}] + experiment_params
        else:
            self.experiment_params = experiment_params
        self.experiments_run = 0
        self.num_experiments = len(self.experiment_params)
        self.results = []

    def next_config(self):
        """Each experiment's config in turn (a generator)."""
        while self.experiments_run < self.num_experiments:
            updated = copy.deepcopy(self.base_config)
            experiment = self.experiment_params[self.experiments_run]
            if len(experiment.keys()) != 1:
                raise ValueError("invalid experiment dict supplied")
            name = list(experiment.keys())[0]
            overrides = experiment[name]
            if overrides:
                updated.update_config(**overrides)
            updated.save_path = f"{updated.save_path}/{name}"
            updated.reinitialize_save_dirs()
            self.current_config = updated
            self.current_experiment_name = name
            yield self.current_config
            self.experiments_run += 1

    def add_result(self, train_batch_history, valid_batch_history,
                   train_epoch_history, valid_epoch_history, model_name=""):
        self.results.append(TrainResult(
            model_name or self.current_experiment_name or "experiment",
            train_batch_history, train_epoch_history,
            valid_batch_history, valid_epoch_history))

    def serialize_last_result(self, path):
        self.results[-1].save_as_json(path)

    @staticmethod
    def initialize_experiment(base_config, experiment_params, include_base_config=True):
        return Experiment(base_config, experiment_params, include_base_config)
