from .fault import InjectedFailure, TrainDriver

__all__ = ["InjectedFailure", "TrainDriver"]
