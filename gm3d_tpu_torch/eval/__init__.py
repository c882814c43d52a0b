"""Evaluation: the linear-SVM probe and the linear C-SVC it fits."""
