from .app import CFG_PRESETS, TRUNCATION_PRESETS, DemoSession

__all__ = ["DemoSession", "CFG_PRESETS", "TRUNCATION_PRESETS"]
