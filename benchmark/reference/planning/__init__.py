"""The reference's MPPI planner."""
