"""Offline cue generation, the port of `mde_tpu/offline/`: inference,
training and evaluation.

  hrnet.py            HRNetV2-W48 + C1 (CSAIL names), `load_hrnet_c1`, the
                      five-scale test protocol
  semseg_zoo.py       CSAIL's zoo: ResNet-18/50/101 (dilated or not),
                      ResNeXt-101, MobileNetV2-dilated and HRNetV2 encoders,
                      C1, PPM and UPerNet decoders, `SegmentationModel`,
                      `load_segmentation_model`
  swin.py, fpn.py     Swin-B and the FPN neck (mmdet names), the bicubic
                      position-table resize
  cascade_rcnn.py     Cascade Mask R-CNN inference, `load_detector`, the
                      host functions `paste_masks` and `collapse_detections`
  detection_ops.py    anchors, delta decoding, fixed-capacity NMS, RoIAlign
  layers.py           float32 norms, the compute-dtype cast, seeded
                      initialisation, the checked state_dict load
  generate_semantics.py, generate_instances.py
                      the CLIs (`python -m mde_tpu_torch.offline.generate_*`)
                      that write the cue side files the cue configurations
                      train on
  detection_train.py  the detector's assigner, sampler, coders, losses and
                      mask targets (`CascadeMaskRCNN.compute_losses`)
  detection_data.py   AutoAugment, GT padding, the AdamW recipe
  coco_dataset.py, detection_eval.py
                      the COCO instance loader and the mAP evaluator
  hrnet_train.py      the zoo's training step (NLL with ignore, SGD + poly)
  train_detector.py, eval_detector.py, eval_semseg.py
                      the training and evaluation CLIs

No TPU kernel lies on this path: the JAX package runs it as XLA code, and
the port as plain PyTorch (cuDNN and cuBLAS for the convolutions and
products). Imports nothing of jax, flax, mde_tpu, PIL or matplotlib.
"""

from .cascade_rcnn import CascadeMaskRCNN, load_detector
from .hrnet import HRNetV2C1, hrnet_multiscale_inference, load_hrnet_c1
from .semseg_zoo import SegmentationModel, load_segmentation_model

__all__ = ["CascadeMaskRCNN", "HRNetV2C1", "SegmentationModel", "hrnet_multiscale_inference",
           "load_detector", "load_hrnet_c1", "load_segmentation_model"]
