from .synthetic import SyntheticLM  # noqa: F401
