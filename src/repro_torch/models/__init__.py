"""Model stacks of the port (``repro/models``): the dense decoder-only
transformer (``transformer``) behind the ``Model`` facade (``lm``)."""
