from . import handler  # the submodule; its handler() fn is handle_job here
from .config import ServeConfig, device_info, load_config, scan_voices
from .handler import build_sample_fn, health_check, synthesize
from .handler import handler as handle_job
from .models import load_models

__all__ = ["ServeConfig", "build_sample_fn", "device_info", "handle_job",
           "handler", "health_check", "load_config", "load_models",
           "scan_voices", "synthesize"]
