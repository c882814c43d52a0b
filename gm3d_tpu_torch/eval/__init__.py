"""Evaluation: the linear-SVM probe, the linear C-SVC it fits, and the
classifier's accuracy."""
