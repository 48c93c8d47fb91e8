"""PyTorch + CUDA port of the YOLOv3 detection framework
(``yolov3_tensorflow_tpu``), for NVIDIA Hopper GPUs.

This slice ports the serving path of the flagship ResNet-18 YOLOv3:
uint8 letterboxed batch -> normalize -> eval forward (with the fused stem
on a hand-written CUDA kernel) -> decode -> batched per-class NMS ->
un-letterbox -> dynamic batcher.  Entry points: ``models.detector.
build_detector``, ``infer.predict.Predictor``, ``infer.server.
DetectionEngine`` / ``DynamicBatcher``, ``ops.nms.BatchedNMS``; weights
from the JAX package come over through ``tools.import_flax``.
"""
