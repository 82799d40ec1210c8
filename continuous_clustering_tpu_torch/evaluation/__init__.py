"""Synthetic scenes and partition comparison (the port's copies of the JAX package's ``evaluation/synthetic.py`` and ``evaluation/partition.py``)."""
