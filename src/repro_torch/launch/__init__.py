"""Train recipes and drivers of the port (``repro.launch``)."""
