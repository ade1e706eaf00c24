"""Online-training frame-window curriculum as a pure state machine.

Counterpart of the reference StarOnlineCallback
(callbacks/online_training_callback.py:90-162): at each epoch end, the
average fine loss decides whether to admit the next frame into the training
window. Rules mirrored exactly:

- while the window is at its initial size (k0 frames), advance as soon as
  avg fine loss <= m2; the first advance tightens the threshold to 95e-5,
- afterwards, require more than `min_epochs_between` (70) epochs since the
  last advance AND avg loss <= threshold,
- training stops once current_frame > num_frames.

Being a pure function of (state, loss), it is trivially checkpointable and
unit-testable — the reference keeps this state in callback attributes and a
Lightning buffer.

The port's own copy of startrax/train/curriculum.py (the standard
library alone), kept so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CurriculumConfig:
    num_frames: int
    initial_num_frames: int = 5
    online_thres: float = 1e-3
    tightened_thres: float = 95e-5
    min_epochs_between: int = 70


@dataclasses.dataclass(frozen=True)
class CurriculumState:
    current_frame: int
    start_frame: int = 0
    threshold: float = 1e-3
    epochs_since_advance: int = 0
    done: bool = False

    @classmethod
    def initial(cls, cfg: CurriculumConfig) -> "CurriculumState":
        return cls(current_frame=cfg.initial_num_frames, threshold=cfg.online_thres)


def advance(state: CurriculumState, cfg: CurriculumConfig, avg_fine_loss: float) -> CurriculumState:
    """One epoch-end transition."""
    if state.done:
        return state

    if state.current_frame == cfg.initial_num_frames:
        if avg_fine_loss <= state.threshold:
            new_frame = state.current_frame + 1
            return dataclasses.replace(
                state,
                current_frame=new_frame,
                threshold=cfg.tightened_thres,
                epochs_since_advance=0,
                done=new_frame > cfg.num_frames,
            )
        return state

    count = state.epochs_since_advance + 1
    if count > cfg.min_epochs_between and avg_fine_loss <= state.threshold:
        new_frame = state.current_frame + 1
        return dataclasses.replace(
            state,
            current_frame=new_frame,
            epochs_since_advance=0,
            done=new_frame > cfg.num_frames,
        )
    return dataclasses.replace(state, epochs_since_advance=count)
