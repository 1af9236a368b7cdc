from .synthetic import SyntheticLM, batch_for  # noqa: F401
