"""Evaluation: the linear-SVM probe, the linear C-SVC it fits, the
classifier's accuracy and the part segmentation's mIoU."""
