"""tpu_dist_torch.examples — twins of the JAX package's ``examples/``
scripts on the port, run as modules::

    python -m tpu_dist_torch.examples.mpspawn_dist --synthetic
    python -m tpu_dist_torch.examples.example_mp --synthetic
    python -m tpu_dist_torch.examples.train_lm --generate 32
    python -m tpu_dist_torch.examples.example_imagenet --max-steps 30
"""
