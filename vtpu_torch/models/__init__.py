"""Models of the port: ``TransformerLM`` (paged decode and training
paths) and the ai-benchmark models (``resnet``, ``vgg``, ``deeplab``,
``lstm``; ``registry`` names them as the reference does)."""
