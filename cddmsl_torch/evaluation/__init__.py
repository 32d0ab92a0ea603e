from .coco_eval import COCOEvaluator
from .evaluator import inference_on_dataset, print_csv_format, verify_results
from .pascal_voc import PascalVOCDetectionEvaluator
