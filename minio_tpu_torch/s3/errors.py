"""S3 API errors and their XML (``minio_tpu/s3/errors.py``,
cmd/api-errors.go): the codes the port's front can return, and
``NotImplemented`` for what it does not serve.  Some are raised by a
name other than their code (``InvalidCopySource`` answers
InvalidArgument, ``AdminBucketQuotaExceeded`` XMinioAdminBucketQuotaExceeded),
as the reference raises them.  A part below the minimum
size answers InvalidPart, as the reference does; EntityTooSmall is in
the table for clients that look it up."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass

from ..objectlayer import interface as ol


@dataclass(frozen=True)
class APIError:
    code: str
    description: str
    http_status: int


_ERRORS = {e.code: e for e in (
    APIError("AccessDenied", "Access Denied.", 403),
    APIError("AuthorizationHeaderMalformed",
             "The authorization header is malformed.", 400),
    APIError("AuthorizationQueryParametersError",
             "Error parsing the X-Amz-Credential parameter.", 400),
    APIError("BadDigest", "The Content-Md5 you specified did not match what "
             "we received.", 400),
    APIError("BucketAlreadyExists", "The requested bucket name is not "
             "available. The bucket namespace is shared by all users of the "
             "system.", 409),
    APIError("BucketAlreadyOwnedByYou",
             "Your previous request to create the named bucket succeeded "
             "and you already own it.", 409),
    APIError("BucketNotEmpty",
             "The bucket you tried to delete is not empty.", 409),
    APIError("EntityTooLarge", "Your proposed upload exceeds the maximum "
             "allowed object size.", 400),
    APIError("EntityTooSmall", "Your proposed upload is smaller than the "
             "minimum allowed object size.", 400),
    APIError("ExpiredToken", "The provided token has expired.", 400),
    APIError("IncompleteBody", "You did not provide the number of bytes "
             "specified by the Content-Length HTTP header.", 400),
    APIError("InternalError", "We encountered an internal error, please "
             "try again.", 500),
    APIError("InvalidAccessKeyId", "The Access Key Id you provided does not "
             "exist in our records.", 403),
    APIError("InvalidArgument", "Invalid Argument", 400),
    APIError("InvalidBucketName", "The specified bucket is not valid.", 400),
    APIError("InvalidDigest", "The Content-Md5 you specified is not valid.",
             400),
    APIError("InvalidPart", "One or more of the specified parts could not be "
             "found.", 400),
    APIError("InvalidPartOrder", "The list of parts was not in ascending "
             "order.", 400),
    APIError("InvalidRange", "The requested range is not satisfiable", 416),
    APIError("InvalidRequest", "Invalid Request", 400),
    APIError("MalformedPOSTRequest", "The body of your POST request is not "
             "well-formed multipart/form-data.", 400),
    APIError("MalformedPolicy", "Policy has invalid resource.", 400),
    APIError("MalformedXML", "The XML you provided was not well-formed or "
             "did not validate against our published schema.", 400),
    APIError("MethodNotAllowed", "The specified method is not allowed "
             "against this resource.", 405),
    APIError("MissingContentLength", "You must provide the Content-Length "
             "HTTP header.", 411),
    APIError("NoSuchBucket", "The specified bucket does not exist", 404),
    APIError("NoSuchBucketPolicy", "The bucket policy does not exist", 404),
    APIError("NoSuchKey", "The specified key does not exist.", 404),
    APIError("NoSuchLifecycleConfiguration",
             "The lifecycle configuration does not exist", 404),
    APIError("NoSuchUpload", "The specified multipart upload does not exist. "
             "The upload ID may be invalid, or the upload may have been "
             "aborted or completed.", 404),
    APIError("NoSuchVersion", "The specified version does not exist.", 404),
    APIError("NotImplemented", "A header you provided implies functionality "
             "that is not implemented", 501),
    APIError("PreconditionFailed", "At least one of the pre-conditions you "
             "specified did not hold", 412),
    APIError("RequestTimeTooSkewed", "The difference between the request "
             "time and the server's time is too large.", 403),
    APIError("RequestTimeout", "Your socket connection to the server was not "
             "read from or written to within the timeout period.", 408),
    APIError("SignatureDoesNotMatch", "The request signature we calculated "
             "does not match the signature you provided. Check your key and "
             "signing method.", 403),
    APIError("SlowDown", "Resource requested is unreadable, please reduce "
             "your request rate", 503),
    # tagging, copy and object lock
    APIError("BadRequest", "400 BadRequest", 400),
    APIError("InvalidBucketObjectLockConfiguration",
             "Bucket is missing ObjectLockConfiguration", 400),
    APIError("InvalidBucketState", "The request is not valid with the "
             "current state of the bucket.", 409),
    APIError("InvalidObjectState", "The operation is not valid for the "
             "object's storage class", 403),
    APIError("InvalidTag", "The tag provided was not a valid tag. A "
             "provided tag key or value was invalid.", 400),
    APIError("NoSuchObjectLockConfiguration", "The specified object does "
             "not have an ObjectLock configuration", 404),
    APIError("NoSuchTagSet", "The TagSet does not exist", 404),
    APIError("ObjectLockConfigurationNotFoundError", "Object Lock "
             "configuration does not exist for this bucket", 404),
    APIError("ObjectLocked", "Object is WORM protected and cannot be "
             "overwritten or deleted", 400),
    # storage classes, SSE and the bucket's default encryption
    APIError("InvalidStorageClass", "The storage class you specified is "
             "not valid", 400),
    APIError("InvalidEncryptionAlgorithmError", "The Encryption request "
             "you specified is not valid. Supported value: AES256.", 400),
    APIError("ServerSideEncryptionConfigurationNotFoundError",
             "The server side encryption configuration was not found", 404),
    # S3 Select (cmd/api-errors.go, the select section)
    APIError("ParseSelectFailure", "The SQL expression contains an invalid "
             "token or is otherwise not parseable.", 400),
    APIError("EvaluatorInvalidArguments", "Incorrect number of arguments in "
             "the function call or invalid evaluation.", 400),
    APIError("InvalidExpressionType", "The ExpressionType is invalid. Only "
             "SQL expressions are supported.", 400),
    APIError("InvalidDataSource", "Invalid data source type. Only CSV and "
             "JSON are supported.", 400),
    APIError("InvalidCompressionFormat", "The file is not in a supported "
             "compression format. Only GZIP is supported.", 400),
    APIError("InvalidRequestParameter", "The value of a parameter in "
             "SelectRequest element is invalid.", 400),
    APIError("CSVParsingError", "Encountered an error parsing the CSV file. "
             "Check the file and try again.", 400),
    APIError("JSONParsingError", "Encountered an error parsing the JSON "
             "file. Check the file and try again.", 400),
    APIError("ReplicationConfigurationNotFoundError",
             "The replication configuration was not found", 404),
    APIError("ReplicationDestinationNotFoundError",
             "The replication destination bucket does not exist", 404),
    APIError("NoSuchWebsiteConfiguration",
             "The specified bucket does not have a website configuration",
             404),
    APIError("NoSuchCORSConfiguration",
             "The CORS configuration does not exist", 404),
)}
# codes the reference answers under another code's name
_ERRORS["InvalidCopySource"] = APIError(
    "InvalidArgument", "Copy Source must mention the source bucket and "
    "key: sourcebucket/sourcekey.", 400)
_ERRORS["InvalidCopyDest"] = APIError(
    "InvalidRequest", "This copy request is illegal because it is trying "
    "to copy an object to itself without changing the object's metadata, "
    "storage class, website redirect location or encryption attributes.",
    400)
_ERRORS["SSECustomerKeyMD5Mismatch"] = APIError(
    "InvalidArgument", "The calculated MD5 hash of the key did not match "
    "the hash that was provided.", 400)
_ERRORS["SSEEncryptedObject"] = APIError(
    "InvalidRequest", "The object was stored using a form of Server Side "
    "Encryption. The correct parameters must be provided to retrieve the "
    "object.", 400)
_ERRORS["InsecureSSECustomerRequest"] = APIError(
    "InvalidRequest", "Requests specifying Server Side Encryption with "
    "Customer provided keys must be made over a secure connection.", 400)
_ERRORS["AdminBucketQuotaExceeded"] = APIError(
    "XMinioAdminBucketQuotaExceeded",
    "Bucket quota may be exceeded with this request.", 403)


def get(code: str) -> APIError:
    return _ERRORS.get(code, _ERRORS["InternalError"])


def has(code: str) -> bool:
    return code in _ERRORS


_OBJECT_ERRORS = {
    ol.BadDigest: "BadDigest",
    ol.BucketNotFound: "NoSuchBucket",
    ol.BucketExists: "BucketAlreadyOwnedByYou",
    ol.BucketNotEmpty: "BucketNotEmpty",
    ol.BucketNameInvalid: "InvalidBucketName",
    ol.ObjectNotFound: "NoSuchKey",
    ol.VersionNotFound: "NoSuchVersion",
    ol.MethodNotAllowed: "MethodNotAllowed",
    ol.ObjectLocked: "ObjectLocked",
    ol.ObjectNameInvalid: "InvalidArgument",
    ol.InvalidRange: "InvalidRange",
    ol.ReadQuorumError: "SlowDown",
    ol.WriteQuorumError: "SlowDown",
    ol.InvalidUploadID: "NoSuchUpload",
    ol.InvalidPart: "InvalidPart",
    ol.InvalidPartOrder: "InvalidPartOrder",
    ol.PreconditionFailed: "PreconditionFailed",
}


def from_object_error(e: Exception) -> APIError:
    """An object-layer error's S3 code (toAPIErrorCode,
    cmd/api-errors.go)."""
    return get(_OBJECT_ERRORS.get(type(e), "InternalError"))


def to_xml(err: APIError, resource: str = "", request_id: str = "") -> bytes:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = err.code
    ET.SubElement(root, "Message").text = err.description
    ET.SubElement(root, "Resource").text = resource
    ET.SubElement(root, "RequestId").text = request_id
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)
