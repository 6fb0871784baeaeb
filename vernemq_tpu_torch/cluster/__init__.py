"""Cluster layer: framed TCP data plane, replicated metadata, membership.

SURVEY.md §2.8: data plane = length-prefixed async TCP (msg/enq frames
with bounded buffering), control/metadata plane = LWW broadcast store with
anti-entropy on (re)connect. The SWC store is the second metadata backend
(vmq_swc analog)."""

from .cluster import Cluster
from .metadata import MetadataStore
