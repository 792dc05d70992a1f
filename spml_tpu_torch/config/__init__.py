from spml_tpu_torch.config.defaults import Config, load_config  # noqa: F401
