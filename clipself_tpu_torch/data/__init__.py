"""Data for the trainer and the evaluator: COCO indexes (`coco.py`), image
files without PIL (`image_io.py`), Pillow's transforms in NumPy
(`transforms.py`), the datasets (`datasets.py`), the loaders and
`device_prefetch` (`loader.py`), the native core's binding
(`native_loader.py`) and seeded synthetic batches (`synthetic.py`)."""
