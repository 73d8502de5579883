from .layer import MoE
from .sharded_moe import GateOutput, TopKGate, moe_layer, top1gating, top2gating
