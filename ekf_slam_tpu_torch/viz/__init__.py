from ekf_slam_tpu_torch.viz.plots import (load_loop_artifacts, plot_frame,
                                    plot_loops, plot_map_3d,
                                    plot_uncertain_surface_xz,
                                    uncertain_surface_xz_hull,
                                    uncertainty_ellipse_points)

__all__ = ["load_loop_artifacts", "plot_frame", "plot_loops",
           "plot_map_3d", "plot_uncertain_surface_xz",
           "uncertain_surface_xz_hull", "uncertainty_ellipse_points"]
