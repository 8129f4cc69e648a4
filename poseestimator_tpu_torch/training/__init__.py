"""training: YOLO11-seg training and synthetic data (counterpart of
``poseestimator_tpu/training/``): the dataset.yaml contract and loader, TAL
assignment, the BCE / CIoU / DFL / mask losses, the single-device trainer
(optax's update laws, EMA, ``torch.save`` checkpoints), mAP evaluation and
the synthetic scene generator. Submodules are imported where used."""
