"""PyTorch models: layers, dense ResNet-50, FPN, heads, RetinaNet
(``models.retinanet.RetinaNet``)."""
