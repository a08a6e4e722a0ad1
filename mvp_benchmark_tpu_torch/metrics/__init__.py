from mvp_benchmark_tpu_torch.metrics.completion import calc_cd, calc_emd, fscore
from mvp_benchmark_tpu_torch.metrics.registration import (
    quat2mat, rmse_loss, rotation_error, rotation_geodesic_error,
    rt_to_transformation, transform_point_cloud, translation_error)

__all__ = ["calc_cd", "calc_emd", "fscore", "quat2mat", "rmse_loss",
           "rotation_error", "rotation_geodesic_error", "rt_to_transformation",
           "transform_point_cloud", "translation_error"]
