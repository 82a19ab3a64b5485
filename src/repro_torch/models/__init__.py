"""The LM stack: layers and family assemblies for the ten assigned
architectures (a PyTorch copy of ``repro.models``)."""

from .registry import ModelBundle, build  # noqa: F401
