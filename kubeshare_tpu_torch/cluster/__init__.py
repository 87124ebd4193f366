from .api import Container, Node, Pod, PodPhase, ClusterAPI
from .fake import FakeCluster

__all__ = ["Container", "Node", "Pod", "PodPhase", "ClusterAPI", "FakeCluster"]
