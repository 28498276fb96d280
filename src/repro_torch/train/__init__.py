"""Training of the port: the train state, the train step and the
fault-tolerant trainer."""
