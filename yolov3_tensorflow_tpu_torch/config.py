"""Configuration system of the PyTorch port.

A copy of ``yolov3_tensorflow_tpu/config.py`` (the port imports nothing of
the JAX package): the same ``Config`` fields, defaults and derived
properties, so a config written for one package means the same model in
the other.  Fields that only steer the TPU build (XLA compiler options,
mesh axes, spatial partitioning) are kept so configs stay interchangeable;
their comments say what the port does with them.  The train knobs whose
features are not ported yet (EMA, freeze_backbone, mixup, gradient
accumulation, transfer init, multi-scale, the loss extensions) raise in
the trainer or the loss when they are set.

The piecewise learning-rate schedule mirrors ``lr_func`` (configs.py:23-27).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Tuple

import numpy as np

# Backbone names (reference: yolov3/yolov3_detector.py:19-23)
BACKBONE_RESNET_18 = "resnet-18"
BACKBONE_RESNET_18_V2 = "resnet-18-v2"
BACKBONE_RESNEXT_18 = "resnext-18"
BACKBONE_MIXNET_18 = "mixnet-18"
BACKBONE_MOBILENET_V2 = "mobilenet-v2"
ALL_BACKBONES = (
    BACKBONE_RESNET_18,
    BACKBONE_RESNET_18_V2,
    BACKBONE_RESNEXT_18,
    BACKBONE_MIXNET_18,
    BACKBONE_MOBILENET_V2,
)

# Default anchors, [W, H] normalized, per head /8, /16, /32
# (reference: configs.py:37-41).  Note the heads may have DIFFERENT numbers
# of anchors (3/2/3 by default) — nothing below hardcodes B=3.
DEFAULT_ANCHOR_BOXES = (
    (
        (0.06618181818181816, 0.1025177510694752),
        (0.18544278606965178, 0.13160367921287464),
        (0.13, 0.32733333333333337),
    ),
    (
        (0.13, 0.32733333333333337),
        (0.303806787732042, 0.34370030784316496),
    ),
    (
        (0.303806787732042, 0.34370030784316496),
        (0.4667050847457627, 0.5281262429095761),
        (0.7906945888923907, 0.7888860433597275),
    ),
)

# Per-head loss-term weights [coord_xy, coord_wh, noobj, obj, cls]
# (reference: configs.py:52).
DEFAULT_LOSS_WEIGHTS = (
    (5.0, 5.0, 0.05, 3.0, 1.0),
    (8.0, 8.0, 0.05, 2.0, 1.0),
    (10.0, 10.0, 0.05, 2.0, 1.0),
)

STRIDES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class Config:
    """All training / inference knobs.  Mirrors reference configs.py FLAGS."""

    # --- dataset (configs.py:31-34) ---
    train_set_dir: str = "dataset/test_sample/images"
    train_label_path: str = "dataset/test_sample/label.txt"
    test_set_dir: str = "dataset/test_sample/images"
    test_label_path: str = "dataset/test_sample/label.txt"

    # --- model geometry (configs.py:36-49) ---
    input_image_size: Tuple[int, int, int] = (384, 480, 3)  # [H, W, C]
    # Multi-scale training sizes [(H, W), ...]; None disables.  This was an
    # unchecked TODO in the reference (README.md:130 多尺度输入); here each
    # size gets its own cached jitted step and epochs cycle through sizes.
    multi_scale_sizes: Tuple[Tuple[int, int], ...] | None = None
    anchor_boxes: Tuple[Tuple[Tuple[float, float], ...], ...] = DEFAULT_ANCHOR_BOXES
    class_num: int = 0
    # Static max number of objects per image; labels are padded with -1 to this
    # length so every shape under jit is static (the reference pads dynamically
    # per batch at dataset/file_util.py:97 — a static bound is the XLA-friendly
    # equivalent).
    max_boxes: int = 32

    # --- loss (configs.py:50-59) ---
    iou_thresh: float = 0.8
    loss_weights: Tuple[Tuple[float, float, float, float, float], ...] = DEFAULT_LOSS_WEIGHTS
    rectified_coord_num: int = 1464
    rectified_loss_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    # --- training (configs.py:54-61, 63-72, 80-87) ---
    train_set_size: int = 20
    val_set_size: int = 20
    batch_size: int = 3
    epoch: int = 300
    init_lr: float = 0.0002
    # optional global-norm gradient clipping (off by default: the reference
    # has none; useful against the schedule's warm-restart LR spikes)
    grad_clip_norm: float | None = None
    # gradient accumulation: average gradients over this many micro-batches
    # before each optimizer update (optax.MultiSteps), emulating an
    # effective batch of grad_accum_steps*batch_size when the target batch
    # does not fit HBM.  steps_per_epoch keeps counting MICRO steps; the
    # LR schedule fires on optimizer (macro) steps, so steps_per_epoch
    # should be a multiple of grad_accum_steps for exact epoch alignment.
    # BatchNorm statistics still update per micro-batch (standard
    # accumulation semantics — not bit-identical to a single big batch).
    grad_accum_steps: int = 1
    # exponential moving average of the model weights (0 = off).  The
    # shadow follows tf.train.ExponentialMovingAverage semantics — after
    # each optimizer update, shadow -= (1 - d) * (shadow - param) with the
    # num_updates-dynamic decay d = min(ema_decay, (1 + t) / (10 + t))
    # (t = optimizer/macro update count, so with grad_accum_steps > 1 the
    # shadow moves once per MACRO update).  BN moving statistics are
    # already their own exponential average (momentum 0.9, layers.py) and
    # are NOT double-smoothed.  When on, every inference surface —
    # eval_step/val_loss, forward/predict, int8 calibration+inference,
    # save_pb/save_serving exports, Keras export — scores the EMA
    # weights; training math is untouched.  The shadow is part of the
    # checkpointed train state; enabling EMA on an existing EMA-less
    # checkpoint seeds the shadow from the restored weights.
    ema_decay: float = 0.0
    # transfer-learning init: path to ANOTHER run's checkpoint directory.
    # On a fresh run (no checkpoint in this run's own directory) every
    # donor param/batch-stat leaf whose tree path AND shape match is
    # copied into the fresh init; mismatching leaves (e.g. the head
    # output convs when class_num differs) keep their fresh init.  This
    # is the Keras fine-tune workflow the reference enables via
    # ``load_weights(..., by_name=True, skip_mismatch=True)`` on the
    # checkpoints its trainer writes (yolov3/trainer.py:47-67,90-91).
    # Optimizer slots, step, RNG and the rectified counter stay fresh.
    # Ignored (with a log line) when the run resumes its own checkpoint.
    init_from: str = ""
    # Fine-tuning: zero the backbone's gradient updates so only the
    # detection heads train.  BatchNorm MOVING STATISTICS still adapt to
    # the new data (Keras-1 trainable=False semantics — only weights
    # freeze; BN inference-mode freezing is a TF2 behavior change the
    # reference's TF 1.13 never had, and stats tracking the new domain
    # is what fine-tuning wants).  The L2 regularizers still *report*
    # frozen params in the loss value; their gradients are zeroed.
    freeze_backbone: bool = False
    mode: str = "train"  # train, test, predict, save_pb, save_serving
    model_backbone: str = BACKBONE_RESNET_18
    optimizer: str = "radam"  # sgdm, adam, radam
    is_augment: bool = True
    # is_label_smoothing is declared-but-dead in the reference (configs.py:67
    # only feeds the run tag); here it is actually wired: the class CE target
    # becomes onehot*(1-eps) + eps/C (classification only, the standard
    # formulation).  is_gradient_harmonized is likewise declared-but-dead in
    # the reference (configs.py:71, README.md:133 roadmap) and wired here:
    # GHM-C (Li et al., AAAI 2019) on the confidence terms — per head, the
    # participating anchors' (background + object) gradient norms
    # g = |score - target| are binned into ghm_bins unit-range bins and each
    # candidate's CE is weighted 1/(bin_count * nonempty_bins) (the official
    # implementation's normalization, batch-local density, no EMA).  The
    # noobj/obj breakdown slots report the harmonized terms (batch-global
    # sums — the density already normalizes across the batch); coord/class
    # terms are untouched; focal and GHM are alternative re-weightings of
    # the same confidence CE, so YOLOv3Loss raises when both are set
    # (a silent GHM-wins precedence would make focal_gamma sweeps no-ops).
    is_label_smoothing: bool = False
    label_smoothing_eps: float = 0.1
    is_focal_loss: bool = False
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    is_gradient_harmonized: bool = False
    ghm_bins: int = 30  # unit-range gradient-norm bins (paper's M)
    is_tiou_recall: bool = False
    # --- reference roadmap items (unchecked TODOs, README.md:127-137) ---
    # GIOU box regression (README.md:134 "GIOU"): replaces the xy-BCE +
    # wh-MSE coordinate pair with scale * (1 - GIOU(pred, target)) at the
    # responsible anchors (Rezatofighi et al., CVPR 2019).  Weighted by
    # the per-head xy coord weight; the wh breakdown slot reports 0.
    is_giou_loss: bool = False
    # mixup (README.md:131 "mixup"): blend image pairs with per-image
    # Beta(alpha, alpha) weights inside the jitted train step and train on
    # the union of their boxes, each box's loss contribution weighted by
    # its source image's blend weight (Zhang et al. 2019, "Bag of Freebies
    # for Training Object Detection Neural Networks", detection mixup).
    is_mixup: bool = False
    mixup_alpha: float = 1.5
    # Gaussian YOLO (README.md:135 "Guassian YOLO"; Choi et al., ICCV
    # 2019): each anchor additionally predicts 4 localization
    # uncertainties — per-anchor layout [t_x,t_y,t_w,t_h,
    # sigma_x,sigma_y,sigma_w,sigma_h, obj, classes...], box_len = 9+C.
    # Training: the xy-BCE + wh-MSE pair becomes per-coordinate Gaussian
    # NLL (sigma = sigmoid of the raw channel), same scale/assignment
    # weighting; obj/noobj/class terms unchanged.  Inference: the decoded
    # objectness is multiplied by the localization certainty
    # (1 - mean sigma), the paper's detection criterion — NMS/post-process
    # consume the standard decoded layout unchanged.  Mutually exclusive
    # with is_giou_loss (both replace the coordinate pair).
    is_gaussian_yolo: bool = False
    # Training-side floor on the Gaussian-NLL sigmas.  The NLL is
    # unbounded below in sigma (0.5*log(2*pi*s^2) -> -inf) and its
    # gradient grows as delta^2/s^3: with sigma clipped only at
    # cfg.epsilon the coordinate terms dominate every step's gradient
    # budget on the shared trunk and the OBJECTNESS head never trains.
    # Measured on the real 13-class sample overfit gate (round 4):
    # floor=eps -> mAP 0.0000 (max objectness stuck at 0.10-0.24);
    # floor=0.1 -> 0.5861 (the NLL still weights coordinates ~50x the
    # BCE/MSE pair via delta^2/(2 s^2)); floor=0.3 (~5.6x) -> 0.9911,
    # ABOVE the standard loss's 0.9721 on the same protocol.  The
    # floor applies to the LOSS only — the decode-side certainty
    # criterion (1 - mean sigma) stays Choi's.
    gaussian_sigma_min: float = 0.3

    # piecewise LR schedule (configs.py:14-20).  The check_* arrays are the
    # reference's manual LR-range-finding protocol (configs.py:14-15): set
    # step_epoch/step_lr to them to sweep learning rates early in a project.
    step_epoch: Tuple[int, ...] = (20, 60, 80, 220, 260, 280, 300)
    step_lr: Tuple[float, ...] = (
        0.01e-3, 1.0e-3, 0.1e-3, 1.0e-3, 0.1e-3, 0.01e-3, 0.001e-3)
    check_step_epoch: Tuple[int, ...] = (2, 4, 6, 8, 10, 12, 14)
    check_step_lr: Tuple[float, ...] = (
        0.00001e-3, 0.0001e-3, 0.001e-3, 0.01e-3, 0.1e-3, 1.0e-3, 10.0e-3)

    # --- callbacks / checkpointing (configs.py:84-96) ---
    ckpt_period: int = 50
    stop_patience: int = 500
    stop_min_delta: float = 1e-4
    # early-stop metric: "loss" is the reference's EarlyStopping monitor
    # (trainer.py:92-93); "val_loss" (the keras default) additionally
    # requires a wired validation set (--val_label_path); "val_map"
    # maximizes the periodic held-out mAP (--val_map_every N — patience
    # counts EVALUATED epochs, i.e. every N-th)
    stop_monitor: str = "loss"
    ckpt_max_keep: int = 3
    root_path: str = ""
    log_dir: str = "logs"

    # --- test / predict (configs.py:99-102) ---
    confidence_thresh: float = 0.8
    nms_thresh: float = 0.4
    save_path: str = "dataset/test_result/"
    image_root_path: str | None = None
    max_detections: int = 128  # static NMS output size (device NMS)
    # test-mode metric style: "voc" = mAP@0.5, all-point interpolation
    # (the Cartucho/mAP convention the reference delegates to,
    # run.py:78-79); "coco" = mAP@[.50:.05:.95], 101-point
    # interpolation + COCO matching (infer/evaluator.evaluate_map_range)
    map_style: str = "voc"
    # test-mode report artifacts: non-empty writes Cartucho-style
    # results.txt + per-class PR-curve plots + AP / GT-count bar charts
    # (the external tool's output/ the reference delegates to,
    # run.py:78-79) into this directory (infer/map_report.py)
    map_report_dir: str = ""
    # class.txt-convention names (one per line, line k = class k, e.g.
    # dataset/test_sample/class.txt) labeling report artifacts;
    # empty = numeric class_<id> labels
    class_name_path: str = ""

    # --- devices.  num_devices<=0 means "all available".  The port's
    # entry points take an explicit ``device`` argument instead; the
    # remaining fields of this block steer the TPU mesh and the port
    # ignores them.
    num_devices: int = 0
    data_axis: str = "data"  # TPU mesh axis name; ignored by the port
    model_axis: str = "model"  # TPU mesh axis name; ignored by the port
    # Spatial partitioning of the image height over the TPU mesh's model
    # axis (GSPMD halo exchange).  No counterpart in the port; ignored.
    spatial_partition: int = 1

    # --- numerics ---
    # keras.backend.set_epsilon(1e-8) (reference run.py:26)
    epsilon: float = 1e-8
    # bfloat16 compute on the conv path (fp32 master params); the reference
    # is fp32-only.  "float32" runs every conv in fp32 (the fused stem
    # still rounds its BN apply to bf16, as the TPU kernel does).
    compute_dtype: str = "bfloat16"
    # conv algorithm: "xla" is direct convolution; "winograd" runs the
    # train-only fused Winograd chain (ops/winograd.py, the CUDA kernel
    # on the card) where the JAX package's shape rules admit a block;
    # eval always runs direct convolution, in both packages.
    conv_backend: str = "xla"
    # Winograd chain channel floor (train-only, see conv_backend): a conv
    # joins the chain only where both its channel counts reach it.  At 64
    # module 1's blocks join, the second through the residual-boundary
    # modes (hconv_bn_add_act_stats).
    winograd_min_channels: int = 128
    # grouped-conv algorithm for resnext-18 (not yet ported).
    grouped_backend: str = "auto"  # auto | grouped | dense
    # stem algorithm.  "auto" and "fused" run the fused BN + pool + relu
    # op (ops/stem_pool.py): in eval the code-free kernel, in train the
    # forward with argmax codes and the code-routed backward; each is
    # the hand-written CUDA kernel on a CUDA tensor and its plain PyTorch
    # version on a CPU tensor.  "xla" runs the plain composition
    # conv_bn -> max_pool -> relu (autograd in train).
    stem_backend: str = "auto"
    # Noise stage of the train-step augmentation: "fused" is the CUDA
    # kernel (ops/augment_noise.py), "xla" draws the noise from the
    # step's torch.Generator; "auto" is the one that won on the H100
    # (train/trainer.py AUTO_AUGMENT_BACKEND, PERF.md).
    augment_backend: str = "auto"  # auto | fused | xla
    # Post-training int8 inference (not yet ported: the port raises on
    # "int8").
    quant: str = "none"  # none | int8
    # Per-program XLA compiler options of the TPU build.  No counterpart
    # in the port; ignored.
    compiler_options: "Tuple[Tuple[str, object], ...]" = None

    # ------------------------------------------------------------------ #
    # Derived fields (reference configs.py:43-49,73-79)
    # ------------------------------------------------------------------ #
    @property
    def box_num(self) -> Tuple[int, ...]:
        return tuple(len(a) for a in self.anchor_boxes)

    @property
    def box_len(self) -> int:
        # +4 sigma channels when Gaussian YOLO is on (README.md:135)
        return 4 + (4 if self.is_gaussian_yolo else 0) + 1 + self.class_num

    @property
    def head_channel_nums(self) -> Tuple[int, ...]:
        return tuple(b * self.box_len for b in self.box_num)

    @property
    def head_grid_sizes(self) -> Tuple[Tuple[int, int], ...]:
        h, w = self.input_image_size[0], self.input_image_size[1]
        return tuple((h // s, w // s) for s in STRIDES)

    @property
    def head_names(self) -> Tuple[str, ...]:
        return ("yolov3_head_8", "yolov3_head_16", "yolov3_head_32")

    @property
    def type(self) -> str:
        tag = f"{self.model_backbone}-{self.optimizer}"
        tag += "-aug" if self.is_augment else ""
        tag += "-smooth" if self.is_label_smoothing else ""
        tag += "-focal" if self.is_focal_loss else ""
        tag += "-ghm" if self.is_gradient_harmonized else ""
        tag += "-TIOU" if self.is_tiou_recall else ""
        # roadmap-item flags (beyond the reference's tag vocabulary,
        # configs.py:73-78 — kept appended so reference tags are a prefix)
        tag += "-giou" if self.is_giou_loss else ""
        tag += "-mixup" if self.is_mixup else ""
        tag += "-gaussian" if self.is_gaussian_yolo else ""
        return tag

    @property
    def log_path(self) -> str:
        return os.path.join(self.log_dir, f"log-{self.type}.txt")

    @property
    def tensorboard_dir(self) -> str:
        """root_path + log_dir + run tag (configs.py:90-92).  The
        reference hardcodes 'logs/' here while log_path honors a
        relocatable dir; both destinations follow ``log_dir`` so one
        knob moves ALL run logs (an absolute log_dir overrides
        root_path via os.path.join semantics, same as log_path)."""
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        return os.path.join(self.root_path, self.log_dir,
                            f"lpr-{self.type}-{stamp}")

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.root_path, "models", self.type)

    @property
    def serving_model_dir(self) -> str:
        return os.path.join(self.root_path, "models", "serving")

    @property
    def pb_model_dir(self) -> str:
        return os.path.join(self.root_path, "models", "pb")

    @property
    def steps_per_epoch(self) -> int:
        return int(np.ceil(self.train_set_size / self.batch_size))

    @property
    def validation_steps(self) -> int:
        return int(np.ceil(self.val_set_size / self.batch_size))

    def lr_func(self, epoch: int) -> float:
        """Piecewise-constant LR by epoch (reference configs.py:23-27)."""
        i = 0
        while i < len(self.step_epoch) and epoch > self.step_epoch[i]:
            i += 1
        return self.step_lr[min(i, len(self.step_lr) - 1)]

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def default_config() -> Config:
    return Config()
