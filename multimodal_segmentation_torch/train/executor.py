"""Training executor: the epoch loop around the training steps.

Port of multimodal_segmentation_tpu/train/executor.py:35-510 for DAFNet
expert pairing (reference model_executors/base_executor.py,
dafnet_executor.py): the labelled / unlabelled paths per l_mix (with
`randomise`), the discriminator pools, per-epoch SWA, validation Dice on
the SWA weights, early stopping with CSV replay on resume, checkpoints with
auto-resume, the component .npz export and the image artifacts; then the
tester on the SWA weights.

Everything runs on `device`, 'cuda' unless the caller passes 'cpu'. Each
step's batch is on the device before the step asks for it
(data/prefetch.py); the step's metrics stay on the device until the
epoch's end, and validation moves only its Dice scalars to the host.
"""

import contextlib
import logging
import os
import time

import numpy as np
import torch

from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.data.batches import DAFNetTrainingData
from multimodal_segmentation_torch.data.loader_factory import init_loader
from multimodal_segmentation_torch.data.prefetch import prefetch_to_device
from multimodal_segmentation_torch.eval.tester import ModelTester
from multimodal_segmentation_torch.models import full_f32_matmuls
from multimodal_segmentation_torch.models.dafnet import resolve_device
from multimodal_segmentation_torch.train.early_stopping import EarlyStopping
from multimodal_segmentation_torch.train.state import create_train_state, swa_copy
from multimodal_segmentation_torch.train.steps import make_steps
from multimodal_segmentation_torch.train.swa import swa_update
from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager
from multimodal_segmentation_torch.utils.observability import LossLogger, TrainingImageCallback

log = logging.getLogger("executor")


class Executor:
    """Shared scaffolding (reference model_executors/base_executor.py:14).

    Args:
      conf: the ExperimentConfig; conf.folder receives every artifact.
      model: the model, its weights already on `device`.
      device: where training runs; 'cuda' raises without a card.
    """

    def __init__(self, conf, model, device="cuda"):
        self.conf = conf
        self.model = model
        self.device = resolve_device(device)
        w_dev = next(model.parameters()).device
        if w_dev != self.device:
            raise ValueError("the model's weights are on %s, not on %s" % (w_dev, self.device))
        if self.device.type == "cuda":
            full_f32_matmuls()
        loader_kwargs = {"hw": conf.input_hw} if conf.dataset_name == "synthetic" else {}
        self.loader = init_loader(conf.dataset_name, **loader_kwargs)
        self.loader.modalities = list(conf.modality)
        self.steps = make_steps(model, conf)
        self.ckpt = CheckpointManager(conf.folder)
        self.train_data = None
        self.early_stopping = None
        self.final_state = None
        # {epoch: {part: seconds}} for the epochs train() ran: training,
        # validation, images, checkpoint, export
        self.epoch_seconds = {}
        self._val_arrays = None

    # ---------------------------------------------------------------- data

    def init_train_data(self):
        conf = self.conf
        self.train_data = DAFNetTrainingData(conf, self.loader)
        self.batches = int(np.ceil(self.train_data.data_len / conf.batch_size))
        if conf.steps_per_epoch:
            self.batches = min(self.batches, conf.steps_per_epoch)
        self.batch_iter = prefetch_to_device(self.train_data.assembled_batches(), self.device)

    # ------------------------------------------------------------ training

    def create_state(self):
        """A fresh train state, or the latest checkpoint's; without a
        checkpoint, any <folder>/models/*.npz component weights seed both
        the live parameters and the SWA average (executor.py:203-228).
        Returns (ts, the first epoch to run)."""
        ts = create_train_state(self.model, self.conf)
        start_epoch = 0
        latest = self.ckpt.latest_epoch()
        if latest is not None:
            log.info("Resuming from checkpoint at epoch %d", latest)
            self.ckpt.restore(latest, ts)
            start_epoch = latest + 1
        elif self.ckpt.load_component_weights(os.path.join(self.conf.folder, "models"),
                                              self.model):
            ts.swa = swa_copy(self.model)
        return ts, start_epoch

    @contextlib.contextmanager
    def _timed(self, seconds, part):
        """seconds[part] = the block's wall time, up to the end of the work
        it queued on the device."""
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds[part] = time.perf_counter() - t

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        folder = os.path.join(self.conf.folder, "profile")
        os.makedirs(folder, exist_ok=True)
        prof.export_chrome_trace(os.path.join(folder, "trace.json"))

    def train(self):
        conf = self.conf
        os.makedirs(conf.folder, exist_ok=True)
        self.init_train_data()
        ts, start_epoch = self.create_state()

        loss_logger = LossLogger(conf.folder)
        stream = self.train_data.gen_labelled or self.train_data.gen_unlabelled
        img_cb = TrainingImageCallback(conf.folder, self.model, stream.arrays, self.device)
        es = self.early_stopping = EarlyStopping(
            "val_loss_mod2_fused", conf.es_min_delta, conf.es_patience)
        if start_epoch > 0:
            # rebuild the monitor's counters from the earlier run's epoch
            # log, so patience does not restart at the resume epoch
            es.replay_csv(os.path.join(conf.folder, "training.csv"), start_epoch)

        prof_start, prof_end = conf.profile_epochs
        prof = None
        img_every = max(1, conf.image_callback_interval)
        ckpt_every = max(1, conf.checkpoint_interval)
        comp_every = max(1, conf.component_save_interval)
        for epoch in range(start_epoch, conf.epochs):
            seconds = self.epoch_seconds[epoch] = {}
            ts.epoch = epoch
            epoch_metrics = {}
            with self._timed(seconds, "training"):
                if prof_end and epoch == prof_start:
                    prof = self._profiler()
                for _ in range(self.batches):
                    self.train_batch(ts, epoch_metrics)
                if prof is not None and epoch + 1 == prof_end:
                    self._stop_profiler(prof)
                    prof = None
                self.on_epoch_end(ts, epoch)
                logs = {k: float(np.mean(torch.stack(v).cpu().numpy().astype(np.float64)))
                        for k, v in epoch_metrics.items()}
            with self._timed(seconds, "validation"):
                logs.update(self.validate(ts))
            # training.csv before the checkpoint: a resumed run re-runs the
            # epochs after its checkpoint, and replay_csv de-duplicates
            loss_logger.on_epoch_end(epoch, logs)
            log.info("Epoch %d/%d: %s", epoch, conf.epochs,
                     ", ".join("%s=%.4f" % (k, v) for k, v in sorted(logs.items())))
            # test_error.txt: "epoch, -dice" each epoch (callbacks/
            # image_callback.py:64-66), the validation Dice in its place
            with open(os.path.join(conf.folder, "test_error.txt"), "a+") as f:
                f.write("%d, %.3f\n" % (epoch, logs["val_loss"] - 1.0))

            if epoch % img_every == 0:
                with self._timed(seconds, "images"), ts.swa_weights():
                    img_cb.on_epoch_end(epoch)
            stopping = es.update(epoch, logs)
            last = epoch + 1 == conf.epochs
            if epoch % ckpt_every == 0 or stopping or last:
                with self._timed(seconds, "checkpoint"):
                    self.ckpt.save(epoch, ts)
            if epoch % comp_every == 0 or stopping or last:
                with self._timed(seconds, "export"):
                    self.ckpt.save_component_weights(os.path.join(conf.folder, "models"), ts.swa)
            log.info("Epoch %d seconds: %s", epoch,
                     ", ".join("%s %.2f" % kv for kv in seconds.items()))
            if stopping:
                log.info("Finished training from early stopping criterion")
                self.on_train_end(ts)
                self.ckpt.save(epoch + 1, ts)
                break
        if prof is not None:
            self._stop_profiler(prof)

        self.final_state = ts
        return ts

    def train_batch(self, ts, epoch_metrics):
        raise NotImplementedError

    def on_epoch_end(self, ts, epoch):
        pass

    def on_train_end(self, ts):
        pass

    def _collect(self, epoch_metrics, metrics):
        for k, v in metrics.items():
            epoch_metrics.setdefault(k, []).append(v)

    # ---------------------------------------------------------- validation

    def _validation_arrays(self):
        """The validation split on the device; uploaded once, or each epoch
        under conf.randomise, which re-randomises the pairs
        (dafnet_executor.py:317)."""
        conf = self.conf
        if self._val_arrays is not None and not conf.randomise:
            return self._val_arrays
        valid = self.loader.load_all_modalities_concatenated(
            conf.split, "validation", conf.image_downsample)
        if conf.randomise:
            valid.randomise_pairs(length=conf.n_pairs - 1)
        valid.crop(conf.input_hw)
        self._val_arrays = tuple(
            torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            for a in (valid.get_images_modi(0), valid.get_images_modi(1),
                      valid.get_masks_modi(0), valid.get_masks_modi(1)))
        return self._val_arrays

    def validate(self, ts):
        """DAFNet validation losses (dafnet_executor.py:303-354) on the SWA
        weights, Dice on the device: six predict_mask calls, seven logs."""
        images0, images1, masks0, masks1 = self._validation_arrays()
        preds = {}
        with ts.swa_weights():
            for t in ("simple", "def", "max"):
                for name, idx in (("mod2", 1), ("mod1", 0)):
                    preds[(name, t)] = self.model.predict_mask(idx, t, [images0, images1],
                                                               device=self.device)

        def d(m, y):
            return 1.0 - float(losses.dice_torch(m, y, binarise=True))

        logs = {
            "val_loss_mod1": d(masks0, preds[("mod1", "simple")]),
            "val_loss_mod2": d(masks1, preds[("mod2", "simple")]),
            "val_loss_mod2_mod1def": d(masks1, preds[("mod2", "def")]),
            "val_loss_mod1_mod2def": d(masks0, preds[("mod1", "def")]),
            "val_loss_mod2_fused": d(masks1, preds[("mod2", "max")]),
            "val_loss_mod1_fused": d(masks0, preds[("mod1", "max")]),
        }
        logs["val_loss"] = float(np.mean([logs["val_loss_mod1"], logs["val_loss_mod2"],
                                          logs["val_loss_mod2_mod1def"],
                                          logs["val_loss_mod2_fused"]]))
        return logs

    # -------------------------------------------------------------- testing

    def test(self):
        """ModelTester on the SWA weights of the final (or restored) state."""
        with self.final_state.swa_weights():
            ModelTester(self.model, self.conf, device=self.device).run()


class DAFNetExecutor(Executor):
    """DAFNet loop: per batch, the supervised and / or unsupervised step;
    SWA over every parameter from conf.swa_start_epoch; validation on the
    SWA average (dafnet_executor.py:212-284, 303-367)."""

    def train_batch(self, ts, epoch_metrics):
        batch = next(self.batch_iter)
        if "sup" in batch:
            _, metrics = self.steps.step_supervised(ts, batch["sup"])
            self._collect(epoch_metrics, metrics)
        if "unsup" in batch:
            _, metrics = self.steps.step_unsupervised(ts, batch["unsup"])
            self._collect(epoch_metrics, metrics)

    def on_epoch_end(self, ts, epoch):
        swa_update(ts.swa, dict(self.model.named_parameters()), epoch, self.conf.swa_start_epoch)

    def on_train_end(self, ts):
        """The live weights become the SWA average (dafnet_executor.py:
        271-283), copied in place."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(ts.swa[n])


def make_executor(conf, model, device="cuda"):
    """The executor of conf.model. Automated pairing (with its validation
    of the balancer's weights) raises in its step (train/steps.py)."""
    if conf.model == "mmsdnet":
        raise NotImplementedError(
            "the MMSDNet executor is not ported yet (ROADMAP.md, queue A, item 4)")
    return DAFNetExecutor(conf, model, device)
