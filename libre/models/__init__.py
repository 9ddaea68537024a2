from libre.models.volume_scene import VolumeScene

__all__ = ["VolumeScene"]
