from vehicle_counting_tpu_torch.counting.polygon import (
    points_in_polygon,
    is_point_in_polygon,
    boxes_intersect_polygon,
    check_bbox_intersect_polygon,
    cosin_similarity,
    cosine_similarity_batch,
)
from vehicle_counting_tpu_torch.counting.counter import (
    CSV_COLUMNS,
    VehicleCounter,
    assign_directions,
    count_directions,
    find_best_match_direction,
    load_zone_anno,
    save_tracking_to_csv,
)
