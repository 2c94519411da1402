"""Planning layer (reference: presto_tpu/planner): the analyzer emits a
typed PlanNode tree, the optimizer rewrites it, and the local planner
turns it into operator pipelines."""
