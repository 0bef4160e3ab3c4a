"""Point-cloud post-processing of the port (counterpart of
`icepy4d_tpu/post_processing/`): polyline cropping, cloud merging,
meshing (screened Poisson: FFT solve on the device, marching tetrahedra
on the host), the DEM of difference, border features, sections, voxels
and the volume-variation workflow."""

from icepy4d_tpu_torch.post_processing.point_clouds import (  # noqa: F401
    DemOfDifference,
    filter_pcd_by_polyline,
    mesh_from_dsm_grid,
    meshing_poisson,
    read_and_merge_point_clouds,
)
from icepy4d_tpu_torch.post_processing.poisson import (  # noqa: F401
    estimate_normals,
    marching_tetrahedra,
    poisson_reconstruct,
)
from icepy4d_tpu_torch.post_processing.analysis import (  # noqa: F401
    VoxelGrid,
    border_statistics,
    detect_border,
    extract_section,
    extract_sections,
    geometric_features,
    make_pairs,
    plot_sections,
    volume_variations,
    voxel_mesh,
    voxelize,
    write_border_time_series,
    write_voxel_centers,
)
