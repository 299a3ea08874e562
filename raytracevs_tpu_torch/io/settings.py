"""Application settings persistence (SettingsService.cs:9-70 analog).

The reference stores last-opened file, window bounds, panel widths and the
screenshot folder in %APPDATA%/RayTraceVS/settings.json; here the same
shape lives under ~/.raytracevs_tpu/settings.json, the file the JAX
package's viewer reads, so both viewers share their settings.

Copied from raytracevs_tpu/io/settings.py (stdlib only).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Optional


def _default_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".raytracevs_tpu")


@dataclass
class AppSettings:
    last_scene_file: Optional[str] = None
    window_width: int = 1600
    window_height: int = 900
    left_panel_width: float = 200.0
    right_panel_width: float = 300.0
    screenshot_folder: Optional[str] = None
    render_width: int = 1920
    render_height: int = 1080


class SettingsService:
    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or _default_dir()
        self.path = os.path.join(self.directory, "settings.json")
        self.settings = AppSettings()

    def load(self) -> AppSettings:
        try:
            with open(self.path) as f:
                data = json.load(f)
            known = {k: v for k, v in data.items() if k in AppSettings.__dataclass_fields__}
            self.settings = AppSettings(**known)
        except (OSError, ValueError, TypeError):
            self.settings = AppSettings()
        return self.settings

    def save(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(asdict(self.settings), f, indent=2)
