"""Plain PyTorch references of the port's models, importing nothing of the
port: the comparisons the tests hold the port against."""
