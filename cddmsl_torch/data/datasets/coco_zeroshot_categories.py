"""The COCO open-vocabulary category splits (the port's copy of
cddmsl_tpu/data/datasets/coco_zeroshot_categories.py): 65 classes, 48 base
("seen", trained on) and 17 novel ("unseen", evaluated only), the split of
the COCO-OVD benchmark. Names are in `load_coco_json`'s contiguous order.
"""

# the 17 novel classes
COCO_UNSEEN_CLS = [
    "airplane", "bus", "cat", "dog", "cow", "elephant", "umbrella",
    "tie", "snowboard", "skateboard", "cup", "knife", "cake", "couch",
    "keyboard", "sink", "scissors",
]

# the 48 base classes
COCO_SEEN_CLS = [
    "person", "bicycle", "car", "motorcycle", "train", "truck",
    "boat", "bench", "bird", "horse", "sheep", "bear", "zebra", "giraffe",
    "backpack", "handbag", "suitcase", "frisbee", "skis", "kite", "surfboard",
    "bottle", "fork", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "pizza", "donut", "chair", "bed", "toilet", "tv",
    "laptop", "mouse", "remote", "microwave", "oven", "toaster",
    "refrigerator", "book", "clock", "vase", "toothbrush",
]

# all 65
COCO_OVD_ALL_CLS = [
    "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "kite", "skateboard", "surfboard", "bottle", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "pizza", "donut", "cake", "chair", "couch", "bed", "toilet",
    "tv", "laptop", "mouse", "remote", "keyboard", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "toothbrush",
]

assert len(COCO_UNSEEN_CLS) == 17 and len(COCO_SEEN_CLS) == 48
assert len(COCO_OVD_ALL_CLS) == 65
assert set(COCO_OVD_ALL_CLS) == set(COCO_SEEN_CLS) | set(COCO_UNSEEN_CLS)
