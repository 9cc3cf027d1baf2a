"""Training of the port: the train step and the loop (``repro.train``)."""
