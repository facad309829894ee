"""End-to-end models: the tabletop detectors (unordered and organized
clouds), the table memory, Hough segmentation, room segmentation and
layered reconstruction."""
from mapping_private_tpu_torch.models.hough_segmentation import (
    HoughConfig,
    HoughSegment,
    hough_segment,
)
from mapping_private_tpu_torch.models.room_segmentation import (
    RoomSegmentation,
    RoomSegmentationConfig,
    segment_room,
    wall_filter,
)
from mapping_private_tpu_torch.models.table_detector import (
    TableDetection,
    TableDetectorConfig,
    detect_table,
)
from mapping_private_tpu_torch.models.table_memory import (
    Table,
    TableMemory,
    TableObject,
    TableStateInstance,
)

__all__ = [
    "TableDetectorConfig",
    "TableDetection",
    "detect_table",
    "TableMemory",
    "Table",
    "TableObject",
    "TableStateInstance",
    "HoughConfig",
    "HoughSegment",
    "hough_segment",
    "RoomSegmentationConfig",
    "RoomSegmentation",
    "segment_room",
    "wall_filter",
]
