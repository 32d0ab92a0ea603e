from .build import build_detection_test_loader, build_detection_train_loader, get_detection_dataset_dicts, to_device
from .catalog import DatasetCatalog, MetadataCatalog
from .datasets.builtin import register_all
