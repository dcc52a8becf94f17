from .ir import Plan, PlanNode, ScanNode, JoinNode

__all__ = ["Plan", "PlanNode", "ScanNode", "JoinNode"]
