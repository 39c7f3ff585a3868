"""Training executors: the epoch loop around the training steps.

Port of multimodal_segmentation_tpu/train/executor.py:35-556 (reference
model_executors/base_executor.py, dafnet_executor.py, mmsdnet_executor.py):
the labelled / unlabelled paths per l_mix (with `randomise`, or with
`automatedpairing`'s candidate neighbours), the discriminator pools,
validation Dice, early stopping with CSV replay on resume, checkpoints
with auto-resume, the component .npz export and the image artifacts;
then the tester. DAFNet keeps a per-epoch SWA average and validates,
exports and tests it; under automated pairing it also logs the balancer's
mean weight per candidate pair. MMSDNet has no SWA: it validates, exports
and tests its live weights, with its 4-metric validation.

Everything runs on `device`, 'cuda' unless the caller passes 'cpu'. Each
step's batch is on the device before the step asks for it
(data/prefetch.py); the step's metrics stay on the device until the
epoch's end, and validation moves only its Dice scalars to the host.

Data parallelism (executor.py:38-47, 184-193 of the JAX package): with a
`mesh` (parallel/mesh.py) every rank reads the same global batches in the
same order from the same seed and prefetches only its rows; the steps
average gradients and metrics over 'data', so the weights stay
replicated. Every rank validates them, and checks that its logs equal the
other ranks', so early stopping, SWA and the balancer's weights decide
the same everywhere. Rank 0 alone writes the files (training.csv,
test_error.txt, checkpoints, the component export, images, the test's
results); the others wait for it at a barrier. A resume reads the same
checkpoint on every rank.

Tensor parallelism: on a mesh with 'model' > 1 the executor shards the
train state's wide parameters (parallel/sharding.py::tp_shard_train_state,
at sharding.MIN_FEATURES) when it creates it, after any component weights load
and before any checkpoint restores. Every rank then gathers the sharded
leaves for a checkpoint or the export, and makes the model whole
(sharding.unsharded) for the work rank 0 does alone (images, the test);
rank 0 writes one-process files.
"""

import contextlib
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.data.batches import TrainingData
from multimodal_segmentation_torch.data.loader_factory import init_loader
from multimodal_segmentation_torch.data.prefetch import prefetch_to_device
from multimodal_segmentation_torch.eval.tester import ModelTester
from multimodal_segmentation_torch.models import full_f32_matmuls
from multimodal_segmentation_torch.models.base import resolve_device
from multimodal_segmentation_torch.parallel import sharding
from multimodal_segmentation_torch.parallel.distributed import barrier, is_writer
from multimodal_segmentation_torch.parallel.sharding import (
    tp_shard_train_state,
    unsharded,
    whole_named,
)
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
      mesh: a ('data', 'model') mesh for data and tensor parallelism, or
        None.
    """

    def __init__(self, conf, model, device="cuda", mesh=None):
        self.conf = conf
        self.model = model
        self.mesh = mesh
        self.tp = mesh is not None and mesh.shape.get("model", 1) > 1
        self.writes = is_writer(mesh)
        self.device = resolve_device(device)
        w_dev = next(model.parameters()).device
        if w_dev != self.device:
            raise ValueError("the model's weights are on %s, not on %s" % (w_dev, self.device))
        if self.device.type == "cuda":
            full_f32_matmuls()
        loader_kwargs = {"hw": conf.input_hw} if conf.dataset_name == "synthetic" else {}
        self.loader = init_loader(conf.dataset_name, **loader_kwargs)
        self.loader.modalities = list(conf.modality)
        self.steps = make_steps(model, conf, mesh)
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
        self.train_data = TrainingData(conf, self.loader)
        self.batches = int(np.ceil(self.train_data.data_len / conf.batch_size))
        if conf.steps_per_epoch:
            self.batches = min(self.batches, conf.steps_per_epoch)
        self.batch_iter = prefetch_to_device(self.train_data.assembled_batches(), self.device,
                                             self.mesh)

    # ------------------------------------------------------------ training

    def create_state(self):
        """A fresh train state, or the latest checkpoint's; without a
        checkpoint, any <folder>/models/*.npz component weights seed both
        the live parameters and the SWA average (executor.py:203-228).
        Under tensor parallelism the state is sharded in between.
        Returns (ts, the first epoch to run)."""
        ts = create_train_state(self.model, self.conf)
        start_epoch = 0
        latest = self.ckpt.latest_epoch()
        if latest is None and self.ckpt.load_component_weights(
                os.path.join(self.conf.folder, "models"), self.model):
            ts.swa = swa_copy(self.model)
        if self.tp:
            tp_shard_train_state(self.mesh, ts, sharding.MIN_FEATURES)
        if latest is not None:
            log.info("Resuming from checkpoint at epoch %d", latest)
            self.ckpt.restore(latest, ts)
            start_epoch = latest + 1
        return ts, start_epoch

    @contextlib.contextmanager
    def _writer_block(self, ts):
        """A block of work that the writer does alone on the eval weights
        of `ts`; yields whether this rank does it. Under tensor parallelism
        every rank enters (making the model whole is a collective)."""
        if not self.tp:
            if not self.writes:
                yield False
                return
            with self.eval_weights(ts):
                yield True
            return
        with self.eval_weights(ts), unsharded(self.model):
            yield self.writes

    def _save(self, epoch, ts, seconds):
        """The checkpoint of `epoch`: gathered on every rank, written by
        the writer."""
        with self._timed(seconds, "checkpoint"):
            state = self.ckpt.state_of(ts)
            if self.writes:
                self.ckpt.save(epoch, ts, state)

    @contextlib.contextmanager
    def _timed(self, seconds, part):
        """seconds[part] = the block's wall time, up to the end of the work
        it queued on the device."""
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds[part] = time.perf_counter() - t

    def _check_replicated(self, logs):
        """Under a mesh, raise unless every rank's `logs` are this rank's:
        the decisions taken from them must be the same everywhere."""
        if self.mesh is None or not dist.is_initialized():
            return
        t = torch.tensor([logs[k] for k in sorted(logs)], dtype=torch.float64,
                         device=self.device)
        hi, lo = t.clone(), t.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            raise RuntimeError("the ranks' logs differ: %s, spread %s"
                               % (sorted(logs), (hi - lo).tolist()))

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
        if self.writes:
            folder = os.path.join(self.conf.folder, "profile")
            os.makedirs(folder, exist_ok=True)
            prof.export_chrome_trace(os.path.join(folder, "trace.json"))

    def train(self):
        conf = self.conf
        os.makedirs(conf.folder, exist_ok=True)
        self.init_train_data()
        ts, start_epoch = self.create_state()
        writes = self.writes

        loss_logger = LossLogger(conf.folder)
        stream = self.train_data.gen_labelled or self.train_data.gen_unlabelled
        sample = stream.arrays
        if "x1_pairs" in sample:
            # automated pairing: the callback shows pair 0, the expert pair
            # (executor.py:240-249, dafnet_image_callback.py:75-76)
            sample = dict(sample, x1=sample["x1_pairs"][..., 0:1],
                          x2=sample["x2_pairs"][..., 0:1])
        img_cb = TrainingImageCallback(conf.folder, self.model, sample, self.device)
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
            self._check_replicated(logs)
            log.info("Epoch %d/%d: %s", epoch, conf.epochs,
                     ", ".join("%s=%.4f" % (k, v) for k, v in sorted(logs.items())))
            if writes:
                # training.csv before the checkpoint: a resumed run re-runs
                # the epochs after its checkpoint, and replay_csv
                # de-duplicates
                loss_logger.on_epoch_end(epoch, logs)
                # test_error.txt: "epoch, -dice" each epoch (callbacks/
                # image_callback.py:64-66), the validation Dice in its place
                with open(os.path.join(conf.folder, "test_error.txt"), "a+") as f:
                    f.write("%d, %.3f\n" % (epoch, logs["val_loss"] - 1.0))

            if epoch % img_every == 0:
                with self._timed(seconds, "images"), self._writer_block(ts) as mine:
                    if mine:
                        img_cb.on_epoch_end(epoch)
            stopping = es.update(epoch, logs)
            last = epoch + 1 == conf.epochs
            if epoch % ckpt_every == 0 or stopping or last:
                self._save(epoch, ts, seconds)
            if epoch % comp_every == 0 or stopping or last:
                with self._timed(seconds, "export"):
                    params = whole_named(self.model, self.eval_params(ts))
                    if writes:
                        self.ckpt.save_component_weights(os.path.join(conf.folder, "models"),
                                                         params)
            log.info("Epoch %d seconds: %s", epoch,
                     ", ".join("%s %.2f" % kv for kv in seconds.items()))
            if stopping:
                log.info("Finished training from early stopping criterion")
                self.on_train_end(ts)
                self._save(epoch + 1, ts, {})
            barrier(self.mesh)
            if stopping:
                break
        if prof is not None:
            self._stop_profiler(prof)

        self.final_state = ts
        return ts

    def train_batch(self, ts, epoch_metrics):
        """The step of each path of the next batch that l_mix turns on;
        returns the batch."""
        batch = next(self.batch_iter)
        for path, step in (("sup", self.steps.step_supervised),
                           ("unsup", self.steps.step_unsupervised)):
            if path in batch:
                self._collect(epoch_metrics, step(ts, batch[path])[1])
        return batch

    def on_epoch_end(self, ts, epoch):
        pass

    def on_train_end(self, ts):
        pass

    def eval_weights(self, ts):
        """A context in which the model holds the weights that are
        validated, shown, exported and tested (executor.py:265-268)."""
        return contextlib.nullcontext()

    def eval_params(self, ts):
        """{parameter name: tensor} of those weights, for the export."""
        return dict(self.model.named_parameters())

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

    # {log name: (modality, fusion type)} of the validation Dice losses,
    # and the logs whose mean is val_loss
    VALIDATION = {}
    VAL_LOSS_OF = ()

    def validate(self, ts):
        """1 - binarised Dice of each VALIDATION log on the eval weights,
        one predict_mask call each, the Dice on the device; val_loss the
        mean of VAL_LOSS_OF."""
        images0, images1, masks0, masks1 = self._validation_arrays()
        masks = {"mod1": masks0, "mod2": masks1}
        logs = {}
        with self.eval_weights(ts):
            for name, (mod, fusion) in self.VALIDATION.items():
                pred = self.model.predict_mask(int(mod == "mod2"), fusion, [images0, images1],
                                               device=self.device)
                logs[name] = 1.0 - float(losses.dice_torch(masks[mod], pred, binarise=True))
        logs["val_loss"] = float(np.mean([logs[k] for k in self.VAL_LOSS_OF]))
        return logs

    # -------------------------------------------------------------- testing
    # -------------------------------------------------------------- testing

    def test(self):
        """ModelTester on the eval weights of the final (or restored) state;
        under a mesh on rank 0 alone, which writes its results (the
        weights are the same on every rank)."""
        with self._writer_block(self.final_state) as mine:
            if mine:
                ModelTester(self.model, self.conf, device=self.device).run()
        barrier(self.mesh)


class DAFNetExecutor(Executor):
    """DAFNet loop: per batch, the supervised and / or unsupervised step;
    SWA over every parameter from conf.swa_start_epoch; validation on the
    SWA average, and under automated pairing the balancer's weights on the
    live ones (dafnet_executor.py:212-284, 303-367)."""

    VALIDATION = {
        "val_loss_mod1": ("mod1", "simple"),
        "val_loss_mod2": ("mod2", "simple"),
        "val_loss_mod2_mod1def": ("mod2", "def"),
        "val_loss_mod1_mod2def": ("mod1", "def"),
        "val_loss_mod2_fused": ("mod2", "max"),
        "val_loss_mod1_fused": ("mod1", "max"),
    }
    VAL_LOSS_OF = ("val_loss_mod1", "val_loss_mod2", "val_loss_mod2_mod1def",
                   "val_loss_mod2_fused")

    def on_epoch_end(self, ts, epoch):
        swa_update(ts.swa, dict(self.model.named_parameters()), epoch, self.conf.swa_start_epoch)

    def on_train_end(self, ts):
        """The live weights become the SWA average (dafnet_executor.py:
        271-283), copied in place."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(ts.swa[n])

    def eval_weights(self, ts):
        return ts.swa_weights()

    def eval_params(self, ts):
        return ts.swa

    def validate(self, ts):
        """The validation Dice losses (dafnet_executor.py:303-354) on the
        SWA weights; under automated pairing also val_weight_0 ..
        n_pairs - 1."""
        logs = super().validate(ts)
        if self.conf.automatedpairing:
            logs.update(self.validate_balancer_weights())
        return logs

    @torch.inference_mode()
    def validate_balancer_weights(self):
        """The balancer's mean weight per candidate pair on the validation
        split (executor.py:475-510, dafnet_executor.py:356-367), on the
        live weights as in the reference: each of modality 0's n_pairs
        candidates through encode1, modality 1 through encode2, in eval
        mode. Returns {'val_weight_j': float}."""
        conf = self.conf
        valid = self.loader.load_all_modalities_concatenated(
            conf.split, "validation", conf.image_downsample)
        valid.crop(conf.input_hw)
        valid.expand_pairs(conf.n_pairs - 1, 0, neighborhood=conf.n_pairs)

        def nchw(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device).permute(0, 3, 1, 2)

        images0 = valid.get_images_modi(0)
        enc = self.model.enc_anatomy
        s1_list = [enc.encode1(nchw(images0[..., i : i + 1])) for i in range(images0.shape[-1])]
        s2 = enc.encode2(nchw(valid.get_images_modi(1)))
        w = self.model.balancer(s2, s1_list).float().mean(0).cpu().numpy()
        return {"val_weight_%d" % j: float(w[j]) for j in range(conf.n_pairs)}


class MMSDNetExecutor(Executor):
    """MMSDNet loop (mmsdnet_executor.py:159-236): per batch, the generator
    (and Z-regressor) step of each active path, then one mask-discriminator
    step; no SWA: validation, export and test on the live weights."""

    # the 4-metric validation (mmsdnet_executor.py:210-236)
    VALIDATION = {
        "val_loss_mod1": ("mod1", "simple"),
        "val_loss_mod2": ("mod2", "simple"),
        "val_loss_mod2_s1def": ("mod2", "def"),
        "val_loss_mod2_fused": ("mod2", "max"),
    }
    VAL_LOSS_OF = tuple(VALIDATION)

    def train_batch(self, ts, epoch_metrics):
        batch = super().train_batch(ts, epoch_metrics)
        self._collect(epoch_metrics, self.steps.step_discriminator(ts, batch["disc"])[1])
        return batch


def make_executor(conf, model, device="cuda", mesh=None):
    """The executor of conf.model; `mesh` for data and tensor parallelism
    (executor.py:559-562 of the JAX package)."""
    if conf.model == "mmsdnet":
        return MMSDNetExecutor(conf, model, device, mesh)
    return DAFNetExecutor(conf, model, device, mesh)
