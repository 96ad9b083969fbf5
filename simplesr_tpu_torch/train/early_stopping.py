"""Early-stopping patience tracker, as simplesr_tpu.train.early_stopping.

The stop counter advances only when the metric also dropped against the
previous epoch (not merely against the best), and
``num_epochs_after_best() == 0`` is the signal to save a checkpoint.
"""


class EarlyStopping:
    def __init__(self, metric_key, patience):
        self.metric_key = metric_key
        self.patience = patience
        self._epochs_without_improvement = 0
        self._num_epochs_after_best = 0
        self._early_stop = False
        self._current_best_val = float("-inf")

    def evaluate_stop_criterion(self, metric_history):
        """Feed the per-epoch history of the tracked metric (higher is
        better) once per epoch, after appending the newest value."""
        metric_this_epoch = metric_history[-1]
        metric_last_epoch = metric_history[-2] if len(metric_history) >= 2 else float("-inf")
        if metric_this_epoch > self._current_best_val:
            self._epochs_without_improvement = 0
            self._num_epochs_after_best = 0
            self._current_best_val = metric_this_epoch
        else:
            self._num_epochs_after_best += 1
            if metric_this_epoch < metric_last_epoch:
                self._epochs_without_improvement += 1
        if self._epochs_without_improvement >= self.patience:
            self._early_stop = True

    def stop_early(self):
        return self._early_stop

    def num_epochs_after_best(self):
        return self._num_epochs_after_best

    def epochs_without_improvement(self):
        return self._epochs_without_improvement

    @property
    def best_value(self):
        return self._current_best_val

    def state_dict(self):
        """JSON-serialisable counters."""
        return {
            "epochs_without_improvement": self._epochs_without_improvement,
            "num_epochs_after_best": self._num_epochs_after_best,
            "early_stop": self._early_stop,
            "current_best_val": self._current_best_val,
        }

    def load_state_dict(self, state):
        self._epochs_without_improvement = int(state["epochs_without_improvement"])
        self._num_epochs_after_best = int(state["num_epochs_after_best"])
        self._early_stop = bool(state["early_stop"])
        self._current_best_val = float(state["current_best_val"])
