"""YOLO11-seg: model, letterbox, decode, NMS, masks, weight import."""
