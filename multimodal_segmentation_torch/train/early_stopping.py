"""Early stopping with Keras semantics.

The port's own copy of multimodal_segmentation_tpu/train/early_stopping.py
(reference model_executors/dafnet_executor.py:222):
EarlyStopping('val_loss_mod2_fused', min_delta=0.01, patience=60), min mode.
"""

import csv
import os


class EarlyStopping:
    def __init__(self, monitor="val_loss_mod2_fused", min_delta=0.01, patience=60):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.best = float("inf")
        self.wait = 0
        self.stopped_epoch = 0

    def update(self, epoch, logs) -> bool:
        """Returns True when training should stop (Keras on_epoch_end logic)."""
        current = logs.get(self.monitor)
        if current is None:
            return False
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                return True
        return False

    def replay_csv(self, csv_path, before_epoch):
        """Rebuild monitor state from a previous run's training.csv.

        EarlyStopping state is not part of the TrainState or the
        checkpoint (it is host-side, like the Keras callback it mirrors),
        so on
        preemption-resume the best/wait counters would otherwise restart
        at the resume epoch and extend training by up to `patience`
        epochs. Replaying the logged epochs < before_epoch restores the
        exact counters the killed run had.

        training.csv is append-only and rows are written before the
        checkpoint save (and checkpoint_interval>1 re-runs logged epochs),
        so after a kill+resume the file can hold duplicate rows for re-run
        epochs. Rows are deduplicated by epoch (last occurrence wins — the
        re-run value is what the resumed trajectory actually produced)
        before replaying, otherwise each duplicate inflates `wait` and
        early stop fires up to `patience` epochs early.
        """
        if not os.path.exists(csv_path):
            return
        by_epoch = {}
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                try:
                    epoch = int(float(row.get("epoch", "")))
                except ValueError:
                    continue
                if epoch >= before_epoch:
                    continue
                val = row.get(self.monitor)
                if val in (None, ""):
                    continue
                by_epoch[epoch] = float(val)
        for epoch in sorted(by_epoch):
            self.update(epoch, {self.monitor: by_epoch[epoch]})
