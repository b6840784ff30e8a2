from .mesh import default_mesh, make_mesh, plan_group_sharded

__all__ = ["default_mesh", "make_mesh", "plan_group_sharded"]
