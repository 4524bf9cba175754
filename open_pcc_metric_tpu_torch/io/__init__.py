from .loaders import (RawCloud, point_count, read_point_cloud, write_pcd,
                      write_ply)

__all__ = ["read_point_cloud", "write_ply", "write_pcd", "RawCloud",
           "point_count"]
