"""Goal-command audio playback for render mode (a copy of
var_tpu/utils/audio_play.py; host audio, not a device path).

The reference plays the sampled spoken command through sounddevice while
rendering so a human watching the env hears what the robot was told
(reference: Envs/ai2thor/RL_env_VAR.py:507,513 `sd.play(...)`). This is
the counterpart: best-effort, non-blocking, and a silent no-op when the
sounddevice package or an output device is absent (headless containers).
"""
from __future__ import annotations

import warnings

_sd = None  # resolved lazily; False = known unavailable


def _backend():
    global _sd
    if _sd is None:
        try:
            import sounddevice

            # probe for an output device; raises when none exists
            sounddevice.check_output_settings(samplerate=16000, channels=1)
            _sd = sounddevice
        except Exception as e:  # no package / no device / no backend
            warnings.warn(f"goal-audio playback disabled: {e}")
            _sd = False
    return _sd


def play_clip(clip, samplerate: int = 16000) -> bool:
    """Play one mono int16/float waveform without blocking the env step
    (the reference's sd.play is also asynchronous). Returns True when the
    clip was handed to an output device."""
    sd = _backend()
    if not sd or clip is None:
        return False
    try:
        sd.play(clip, samplerate=samplerate, blocking=False)
        return True
    except Exception as e:  # pragma: no cover - device-specific
        warnings.warn(f"goal-audio playback failed: {e}")
        return False
