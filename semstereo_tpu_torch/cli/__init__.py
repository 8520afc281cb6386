"""Command lines of the port: ``python -m semstereo_tpu_torch.cli.train`` and
``python -m semstereo_tpu_torch.cli.evaluate`` (counterparts of the JAX
package's ``scripts/train.py`` and ``scripts/evaluate.py``)."""
