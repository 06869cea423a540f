"""CheckpointManager: rotation, cadence, resume, failure recovery."""
from __future__ import annotations

import pathlib
import shutil
from typing import Any

from repro_torch.checkpoint import ckpt


class CheckpointManager:
    """Keeps the newest `keep` checkpoints, saves every `interval` steps,
    and resumes training state after a crash/restart (runtime.fault wires
    this into the supervised train loop)."""

    def __init__(self, directory, interval: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.interval = int(interval)
        self.keep = int(keep)
        self.async_save = async_save
        existing = self.dir.glob("step_*") if self.dir.exists() else []
        self.saved_steps: list[int] = sorted(
            int(p.name.split("_")[1]) for p in existing
            if (p / "manifest.json").exists()
        )

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def save(self, step: int, tree: Any, extra_meta: dict | None = None,
             force: bool = False):
        if not force and not self.should_save(step):
            return None
        path = ckpt.save_checkpoint(
            self.dir, step, tree, extra_meta, blocking=not self.async_save)
        self.saved_steps.append(step)
        self._rotate()
        return path

    def _rotate(self):
        ckpt.wait_for_pending()
        while len(self.saved_steps) > self.keep:
            victim = self.saved_steps.pop(0)
            shutil.rmtree(self.dir / f"step_{victim:08d}", ignore_errors=True)

    def restore_latest(self, template: Any):
        """Returns (template restored in place, step), or (template, 0) when
        there is nothing to restore (the template untouched)."""
        ckpt.wait_for_pending()
        step = ckpt.latest_step(self.dir)
        if step is None:
            return template, 0
        tree, manifest = ckpt.load_checkpoint(self.dir, template, step)
        return tree, manifest["step"]

    def finalize(self):
        ckpt.wait_for_pending()
