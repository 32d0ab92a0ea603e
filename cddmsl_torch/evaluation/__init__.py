from .coco_eval import COCOEvaluator
from .evaluator import inference_on_dataset, print_csv_format, verify_results
from .lvis_eval import LVISEvaluator
from .pascal_voc import PascalVOCDetectionEvaluator
