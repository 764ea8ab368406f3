from . import checks, config, profiling, runtime

__all__ = ["checks", "config", "profiling", "runtime"]
