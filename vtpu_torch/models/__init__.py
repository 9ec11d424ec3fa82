"""Models of the port: ``TransformerLM`` (dense and paged decode, the
generate entries, the training path) and the ai-benchmark models (``resnet``, ``vgg``, ``deeplab``,
``lstm``; ``registry`` names them as the reference does)."""
